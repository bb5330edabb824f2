"""PyTorch/CUDA port of distributedtraining_tpu, for NVIDIA Hopper (H100).

The JAX package beside it is the reference. This package imports
``torch`` and never ``jax``, ``flax`` or ``distributedtraining_tpu``.
Importing it (or any submodule) has no side effects: the CUDA kernels
under ``csrc/`` are compiled at first use (ops/_cuda.py).

Ported so far, the serving path: ``engine.serve`` (GenerationEngine,
ServeLoop, ServeHTTPFrontend) over ``models.gpt2`` and ``ops``
(attention, embedding lookup, paged-attention decode with its CUDA
kernel), reporting through ``utils.obs``; and the training step:
``engine.train`` (TrainEngine, AdamW) fed by ``data`` (corpora, packer,
batch_iterator), with ``ops.losses``, flash attention with its CUDA
forward and backward kernels, and the miner's ``delta`` algebra.
"""
