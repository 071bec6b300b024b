"""poseidon_tpu_torch — the PyTorch + CUDA port of poseidon_tpu for NVIDIA
Hopper (H100).

A second package beside the JAX one, ported slice by slice and held against
it in the tests. It imports ``torch`` and never ``jax``, and imports no
module of ``poseidon_tpu``: what it needs from the JAX package's jax-free
modules it keeps as its own copy. Module names follow the JAX package's, so
each counterpart is easy to find. Where the JAX package has a Pallas TPU
kernel, the port has a hand-written CUDA kernel under ``ops/csrc/``, built
with ``nvcc`` at first use.

Slice 1 is CNN serving: prototxt -> ``Net`` -> bucketed executor ->
micro-batcher -> socket server, with the cross-channel LRN forward as a
CUDA kernel. Slice 2 is single-device training: LMDB data pipeline ->
``Net`` with its loss -> a train step over one flat parameter arena ->
``Engine`` and the ``train``/``test`` commands, with the LRN backward, the
pooling backward and the fused SGD update as CUDA kernels. Slice 3 is LM
serving: the transformer (``models``) -> bucketed prefill through the
flash-attention forward (a CUDA kernel) -> paged KV pool -> continuous
batching -> the ``generate`` wire op and ``serve --generate``. Slice 4 is
LM training on one device: checkpointed blocks (``core/remat.py``) ->
gradients through the flash attention Function, whose backward is two
CUDA kernels (dQ, dK/dV) -> the per-leaf SGD rule -> LM snapshots ->
``python -m poseidon_tpu_torch.models.train_lm``. Entry points run on
``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
