"""Weight bridge: a parameter tree of numpy arrays → the port's tensors.

The reference builds its trees with ``jax.random``; rather than reproduce
that generator, a caller (the parity tests) converts the reference's tree
to numpy (``np.asarray`` per leaf) and hands it here, so both packages run
on identical weights.  Works for the float tree (``kernel`` (K, N) leaves,
norms, ``embed``, ``codebooks``) and the packed tree (``kernel_packed``
dicts of uint8 buffers and f32 scales) alike; the nesting is kept as is.
"""
from __future__ import annotations

import numpy as np
import torch


def from_numpy_tree(tree, device="cpu"):
    """Nested dicts of array-likes → nested dicts of tensors on ``device``.
    bfloat16 leaves (which numpy cannot hand to torch directly) go through
    float32, exactly."""
    if isinstance(tree, dict):
        return {k: from_numpy_tree(v, device) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)  # a writable copy
