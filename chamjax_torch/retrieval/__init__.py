from chamjax_torch.retrieval.wire import (  # noqa: F401
    encode_request,
    decode_request,
    encode_request_with_lists,
    decode_request_with_lists,
    encode_answer,
    decode_answer,
    request_nbytes,
    request_with_lists_nbytes,
    answer_nbytes,
)
from chamjax_torch.retrieval.interface import (  # noqa: F401
    BaseRetriever,
    DummyRetriever,
    RetrievalResult,
)
from chamjax_torch.retrieval.local import (  # noqa: F401
    DeviceRetriever,
    LocalRetriever,
    MeshRetriever,
    NativeCPURetriever,
)
from chamjax_torch.retrieval.external import ExternalRetriever  # noqa: F401
from chamjax_torch.retrieval.server import (  # noqa: F401
    RandomAnswerServer,
    RetrievalServer,
)
from chamjax_torch.retrieval.coordinator import (  # noqa: F401
    NativeCoordinator,
    RetrieveCoordinator,
)
from chamjax_torch.retrieval.index_scanner import (  # noqa: F401
    IndexScanner,
    IndexServer,
)
