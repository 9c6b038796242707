"""PyTorch/CUDA port of the tpu-ran 5G NR PHY (srsran_project_23_5_tpu).

The JAX package beside this one is the reference; every module here mirrors
its counterpart's path (``ops/ldpc/encoder.py`` ↔
``srsran_project_23_5_tpu_torch/ops/ldpc/encoder.py``) and is held against it
by the ``tests/test_torch_*.py`` parity tests.

Conventions:

- plain functions on tensors; the slot batch is an explicit leading
  dimension (no jit/vmap/scan counterparts);
- every public function takes an explicit ``device`` or works on the device
  of its input tensors; randomness comes from an explicit
  ``torch.Generator``;
- grids are ``[port, symbol, subcarrier]`` complex64 (with the batch in
  front), bits are int8 {0,1}, LLRs are float32 with positive ⇒ bit 0,
  clipped to ``LLR_MAX``.

The two LDPC Pallas kernels of the JAX package are hand-written CUDA C++
kernels for sm_90a (``csrc/``), built at first use by ``utils/kernels.py``.
Their wrappers take the plain PyTorch version only for CPU tensors.

Scale-out (``parallel/``, ``entry.py``) runs one process per rank under
``torch.distributed`` where JAX runs one process over a device mesh: a
rank slices the global carriers or slots to its own and gathers the
results.  Every module of the JAX package has its counterpart here but
for those that are not ported by design (TPU layout workarounds, the XLA
cache and program store, the XLA decoder).

The package imports torch and numpy, never JAX, and nothing of the JAX
package: the numpy helpers it needs (``ran/``, LDPC tables, Gold tables, CRC
remainder matrices, rate-match index maps) are re-hosted here.
"""

__version__ = "0.1.0"
