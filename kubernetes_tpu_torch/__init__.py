"""kubernetes_tpu_torch — the PyTorch and CUDA port of kubernetes_tpu.

The scheduler's per-pod Filter -> Score -> selectHost loop runs as tensor
programs over dense pods x nodes tensors on an NVIDIA GPU. The package
keeps the JAX package's module paths and function names, so each module
has a counterpart in ``kubernetes_tpu`` that it is tested against; it
imports torch and numpy, never JAX and nothing of ``kubernetes_tpu``.

Layout (the modules ported so far):
  api/         core/v1-analog typed objects (Pod, Node, quantities, selectors)
  encode/      snapshot encoder -> bucketed tensors, its pod-delta patches,
               and the churn patches of the resident drain (``patch``);
               ``convert`` carries a JAX-package encoding across
  sched/       the scheduler cache (snapshots, assume, the delta log) and
               the volume constraints the encoder compiles
  ops/         filters, scores, relational plugins; ``csrc/`` holds the CUDA
               kernels and ``kernels`` builds and loads them
  models/      schedule_step (one pass) and gang (batched rounds, the queue
               drain and the device-resident ``drain_step``)
  sidecar/     the gRPC scheduling sidecar
  testing/     pod/node wrappers, the workload generators and the resident
               drain cycle (``resident``)
  device.py    where the port runs: the CUDA card unless the CPU is asked for
"""
