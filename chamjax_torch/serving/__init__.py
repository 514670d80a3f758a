from chamjax_torch.serving.profiling import StepProfiler  # noqa: F401
from chamjax_torch.serving.ralm import (  # noqa: F401
    RalmDecoder,
    RalmEncoderDecoder,
)
from chamjax_torch.serving.tiktok import (  # noqa: F401
    TikTokDecoder,
    TikTokEncoderDecoder,
)
