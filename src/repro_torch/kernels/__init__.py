"""Hand-written Hopper kernels for the paper's compute hot spots.

  ell_gram    — the engine's bundle primitive: fused tril(YYᵀ, −1) + Y·x
                straight from ELL rows (csrc/ell_gram.cu)
  sstep_inner — the s-step correction loop in one launch
                (csrc/sstep_inner.cu)

Each module holds the wrapper, the kernel's plain PyTorch version and a
launch counter. The CUDA sources are compiled at first use
(``_build.py``); importing these modules compiles nothing.
ref.py: plain-torch oracles, including the dense (sb × n) densify path.
"""

from repro_torch.kernels.ell_gram import ell_gram_and_v, ell_gram_and_v_blocked
from repro_torch.kernels.sstep_inner import sstep_inner, sstep_inner_ref

__all__ = [
    "ell_gram_and_v",
    "ell_gram_and_v_blocked",
    "sstep_inner",
    "sstep_inner_ref",
]
