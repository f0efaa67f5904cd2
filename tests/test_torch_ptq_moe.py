"""The port's MoE model in the reference's fake-quant W4A4 modes against the
JAX package, on the smoke ``moonshot_v1_16b``: ``fake`` and ``fake_full``
under every ``act_format``, held as ``tests/test_torch_ptq_model.py``
holds the dense model (``forward_train`` with its 0.01 · aux term and the
``prefill`` logits within 1e-5).  The expert GEMMs quantize the dispatch
buffer (E, C, d) whole — one s_X over every expert's rows, the padding
rows of the trash column's token included — and ``fake_full`` quantizes
the expert activations with BCQ whatever ``act_format`` says, and each
expert stack's weights with one s_X, as the reference does.
"""
import pytest

from repro_torch.models.layers import ACT_FORMATS
from test_torch_ptq_model import MODES, build_model, check_mode, ref  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)


@pytest.fixture(scope="module")
def moe(ref):  # noqa: F811
    return build_model(ref, "moonshot_v1_16b", 1)


@pytest.mark.parametrize("act_format", ACT_FORMATS)
@pytest.mark.parametrize("mode", MODES)
def test_moe_fake_modes_match_reference(ref, moe, mode, act_format):  # noqa: F811
    check_mode(ref, moe, mode, act_format)
