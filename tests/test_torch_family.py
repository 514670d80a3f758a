"""The family record of the RALM loops (``chamjax_torch/serving/ralm.py::
family``): every preset of ``MODEL_PRESETS`` and the ``deepseek_v3``
family resolve to functions that fit together (parameters, a cache, a
prefill, a step and a rewind to the prompt), and an unknown
``model_type`` is refused.  The presets keep their family and heads, cut
to a tiny width, on the CPU; imports no JAX."""

import dataclasses

import pytest
import torch

from chamjax_torch.config import MODEL_PRESETS, ModelConfig
from chamjax_torch.models.kimi_linear import KimiCache, KimiLinearParams
from chamjax_torch.models.llama import LlamaParams
from chamjax_torch.models.mla_moe import LatentCache, MlaMoeParams
from chamjax_torch.models.transformer import KVCache, TransformerParams
from chamjax_torch.serving.ralm import family
from test_torch_kimi_linear import TINY as KIMI_TINY
from test_torch_mla_moe import TINY

CPU = torch.device("cpu")
PARAMS = {"decoder": TransformerParams, "encoder-decoder": tuple,
          "llama": LlamaParams, "deepseek_v3": MlaMoeParams,
          "kimi_linear": KimiLinearParams}


def tiny(name: str):
    """Preset ``name`` at a tiny width (its family and heads kept), or
    the tiny ``deepseek_v3`` or ``kimi_linear`` config."""
    if name == "deepseek_v3":
        return TINY
    if name == "kimi_linear":
        return KIMI_TINY
    cfg = MODEL_PRESETS[name]
    return dataclasses.replace(
        cfg, embed_dim=4 * cfg.attention_heads, ffn_embed_dim=64, layers=1,
        encoder_layers=1, vocab_size=61, max_seq_len=8, dtype="float32")


def _storage(cache):
    return (cache.lat if isinstance(cache, (LatentCache, KimiCache))
            else cache.k)


@pytest.mark.parametrize("name", [*MODEL_PRESETS, "deepseek_v3",
                                  "kimi_linear"])
def test_family_prefills_steps_and_rewinds_to_the_prompt(name):
    """Each family's record: ``init`` gives the family's parameters,
    ``new_cache`` its cache, and after ``prefill`` of a prompt a
    ``rewind`` to the prompt's end sets the count on the device and the
    host and keeps the storage, so the same step gives the same logits;
    a rewind to 0 empties the cache."""
    cfg = tiny(name)
    fam = family(cfg)
    params = fam.init(3, cfg, device=CPU)
    assert isinstance(params, PARAMS[cfg.model_type])
    dec = params[1] if cfg.model_type == "encoder-decoder" else params
    cache = fam.new_cache(cfg, 2, device=CPU)
    assert isinstance(cache, {"deepseek_v3": LatentCache,
                              "kimi_linear": KimiCache}.get(name, KVCache))
    g = torch.Generator().manual_seed(5)
    prompt = torch.randint(1, cfg.vocab_size, (2, 3), generator=g,
                           dtype=torch.int32)
    tok = torch.tensor([4, 9], dtype=torch.int32)
    _, _, cache = fam.prefill(dec, prompt, cache)
    want, _, cache = fam.step(dec, tok, cache)
    ptr = _storage(cache).data_ptr()
    cache = fam.rewind(cache, 3)
    assert cache.host_idx == int(cache.idx) == 3
    got, _, cache = fam.step(dec, tok, cache)
    assert cache.host_idx == int(cache.idx) == 4
    assert _storage(cache).data_ptr() == ptr
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    cache = fam.rewind(cache)
    assert cache.host_idx == int(cache.idx) == 0
    assert not _storage(cache).any() and _storage(cache).data_ptr() == ptr


def test_family_refuses_an_unknown_model_type():
    with pytest.raises(ValueError, match="model_type 'encoder'"):
        family(ModelConfig(model_type="encoder"))
