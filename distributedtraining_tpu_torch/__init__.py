"""PyTorch/CUDA port of distributedtraining_tpu, for NVIDIA Hopper (H100).

The JAX package beside it is the reference. This package imports
``torch`` and never ``jax``, ``flax``, ``optax``, ``msgpack``,
``ml_dtypes`` or ``distributedtraining_tpu``.
Importing it (or any submodule) has no side effects: the CUDA kernels
under ``csrc/`` are compiled at first use (ops/_cuda.py).

Ported so far, the serving path: ``engine.serve`` (GenerationEngine,
ServeLoop, ServeHTTPFrontend) over ``models.gpt2`` and ``ops``
(attention, embedding lookup, paged-attention decode with its CUDA
kernel), reporting through ``utils.obs``; the training step:
``engine.train`` (TrainEngine, AdamW) fed by ``data`` (corpora, packer,
batch_iterator, prefetch), with ``ops.losses``, flash attention with its
CUDA forward and backward kernels, the fused cross-entropy with its CUDA
forward, dh and dW kernels, and the miner's ``delta`` algebra; the
miner's round: ``engine.train.MinerLoop`` publishing through
``engine.publish`` over ``transport`` (in-memory, local filesystem) in
``serialization``'s msgpack or the wire-v2 shard form, driven by
``neurons.miner``; and the averager's round: ``engine.average``
(``WeightedAverage``, ``AveragerLoop``) staging submissions through
``engine.ingest``, weighting them from ``chain`` (the local JSON chain)
and folding packed ones with the CUDA dequantize-scatter-add kernel
(``ops.dequant_scatter``), or learning the mixing weights
(``ParameterizedMerge``) through the flash kernels, driven by
``neurons.averager``; and the validator's round: ``engine.validate``
(``Validator``) scoring cohorts through ``engine.batched_eval`` and
writing chain weights, driven by ``neurons.validator``.
"""
