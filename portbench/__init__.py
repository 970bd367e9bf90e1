"""The benchmark of the PyTorch and CUDA port (``shallowspeed_tpu_torch``).

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of ``BENCHMARK.json`` once on the GPU and prints one JSON
line. Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by the name that
``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the model's sizes and training recipe, and
  its family (``"family"``, ``mlp`` where the key is absent);
- ``families/<family>.py``: everything that depends on the model's
  structure: its weights, session, checkpoint, checked leaves, reference
  and model FLOPs (``families/__init__.py`` lists the functions);
- ``traffic/<traffic>.json``: the split the generator makes from the seed,
  the batch, the session's layout and the chunk a call trains;
- ``workloads/<cell>.json``: what the cell routes to which kernel, how
  many chunks its traced stretch covers, and the limits of its check;
- ``metrics/<metric>.json``: the reader (``readers/<reader>.py``) that
  takes a per-layer metric from the traced stretch, with its parameters.

``work/`` holds the yardsticks (the generator of inputs, FLOP and byte
counts, the table of peaks, the trace arithmetic), ``reference/`` each
family's plain PyTorch training step, which the check compares with. None
of these, nor a family, imports the port; only ``harness.py`` drives it.
Nothing here imports JAX or the JAX package.
"""
