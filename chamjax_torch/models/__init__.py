from chamjax_torch.models.transformer import (  # noqa: F401
    TransformerParams,
    KVCache,
    init_decoder,
    init_encoder,
    init_encoder_decoder,
    decoder_prefill,
    decoder_step,
    encoder_forward,
    init_kv_cache,
)
from chamjax_torch.models.llama import (  # noqa: F401
    init_llama,
    init_llama_kv_cache,
    llama_prefill,
    llama_step,
)
