"""The benchmark of the PyTorch/CUDA port (`repro_torch`) on one NVIDIA H100.

One cell (a model configuration under a traffic mix, named in the repo's
``BENCHMARK.json``) runs once per process:

    python3 -m bench.run --workload qwen-chat-poisson --seed 7 --seconds 51 --trace 0

Everything that belongs to one configuration, one traffic mix or one
per-layer metric lives in a file of its own, found by name:

* ``bench/configs/<config>.json``: the model's sizes as run, its source,
  the engine's shape and the comparison's limit;
* ``bench/traffic/<traffic>.json``: the open-loop mix's parameters, read by
  the one generator `bench.traffic.generator`;
* ``bench/metrics/<metric>.py``: a reader with ``read(run)`` that returns
  the metric or None where the run has nothing for it to read
  (`bench.spec.load_reader`); a roofline reader takes the kernel names it
  matches from ``bench/metrics/kernel_names/<kernel>/*.txt``.

The yardstick (traffic, the FLOP and byte counts and the published peaks,
the device-trace reduction, the plain fp32 reference and the comparison
that decides ``correct``) lives here, never in the program. Nothing under
``bench/`` imports ``jax``, ``jaxlib``, ``flax`` or the JAX package
``repro``; only `bench.serve` and `bench.weights` import ``repro_torch``,
and nothing under ``bench/reference/`` does.
"""
