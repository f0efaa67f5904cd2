"""The LO-BCQ formats the port's format tests run, shared by
``test_torch_formats.py`` (CPU parity with the JAX package) and
``test_torch_cuda_formats.py`` (the kernels against their plain versions
on the card), and codebooks fitted for them.

``PAPER_FORMATS`` are the paper's 25 (``chip_smoke.py``'s phase 24):
Table 8's L_b × L_A × N_c ablation (15), Table 5's W3/W2 (4), Table 10's
INT4/INT6/INT8 codewords (3) and three more (Fig. 4's g128/N_c 16, and
g32/L_b 4, g16/L_b 2 as the reference's kernel tests run them).
``REF_KERNEL_FORMATS`` are the formats of the reference's kernel tests
(``tests/test_kernels.py:19-24``, ``tests/test_fused_linear.py:24-28``).
"""
from repro_torch.core.bcq import BCQConfig, fit_lobcq


def fmt(lb, la, nc, b=4, bc=6) -> BCQConfig:
    return BCQConfig(block_len=lb, array_len=la, n_codebooks=nc, index_bits=b, codeword_bits=bc)


PAPER_FORMATS = (
    [fmt(8, la, nc) for la in (64, 32, 16) for nc in (2, 4, 8, 16)]
    + [fmt(4, 64, 2), fmt(4, 64, 4), fmt(2, 64, 2)]
    + [fmt(8, 128, nc, b=b) for b, nc in ((3, 4), (3, 8), (2, 4), (2, 8))]
    + [fmt(8, 128, 8, bc=bc) for bc in (4, 6, 8)]
    + [fmt(8, 128, 16), fmt(4, 32, 4), fmt(2, 16, 2)]
)

REF_KERNEL_FORMATS = [fmt(8, 64, 8), fmt(8, 128, 16), fmt(4, 32, 4), fmt(2, 16, 2),
                      fmt(8, 64, 16)]


def tag(cfg: BCQConfig) -> str:
    return f"{cfg.tag()}_B{cfg.index_bits}_Bc{cfg.codeword_bits}"


def fitted_levels(cfg: BCQConfig, data, seed: int = 0):
    """Integer codebooks (N_c, 2^B) for ``cfg``: a short LO-BCQ fit on
    ``data`` (a heavy-tailed operand; 4 iterations on 4,096 blocks, as the
    reference's kernel tests fit theirs), levels rounded to INT-B_c."""
    from repro_torch.serving.prng import prng_key

    return fit_lobcq(data, cfg, key=prng_key(seed), iters=4, max_blocks=4096).levels
