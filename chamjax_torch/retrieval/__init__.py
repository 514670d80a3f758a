from chamjax_torch.retrieval.interface import (  # noqa: F401
    BaseRetriever,
    DummyRetriever,
    RetrievalResult,
)
from chamjax_torch.retrieval.local import (  # noqa: F401
    DeviceRetriever,
    LocalRetriever,
)
