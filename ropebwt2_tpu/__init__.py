"""ropebwt2_tpu — a BWT/FM-index construction framework in JAX.

A from-scratch re-design of the capabilities of lh3/ropebwt2 (version r187)
for accelerators with JAX/XLA:

* Incremental, batched BCR-style construction of the multi-string BWT of a DNA
  read collection, with implicit RLO/RCLO sorting (reference: mrope.c:258-345).
* Instead of the reference's six pointer-based B+-trees with run-length leaves
  (rope.c, rle.c), the BWT lives in a flat, array-packed device buffer with
  blockwise count tables; every BCR round is expressed as vectorized rank
  queries + segment-grouped interval arithmetic + one coalesced merge pass.
* Export/import: plain text BWT, FMR (checkpoint/resume, readable by the
  reference), FMD (fermi, rld0.c), and CRLF formats.

BWT positions use int64 (the reference supports 2^61 symbols, mrope.c:176),
so 64-bit mode is enabled at import.
"""

import os

# int64 positions are load-bearing: the reference handles >2^32 symbols
# (mrope.c:174-178 uses 61-bit intervals). Must be set before jax runs.
os.environ.setdefault("JAX_ENABLE_X64", "1")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

# Persistent compilation cache: BCR batch programs are re-jitted per shape
# bucket; caching makes CLI invocations and restarts cheap.  JAX itself
# honours JAX_COMPILATION_CACHE_DIR; without it the cache sits at a fixed
# path inside the checkout, so every process of one checkout shares it.
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

__version__ = "0.1.0"

from .alphabet import SENT, A, C, G, T, N, NT6_TABLE, comp6  # noqa: F401,E402
