"""Model families, one module each: ``families/<family>.py``.

A configuration file names its family by its ``"family"`` key; without the
key the family is ``DEFAULT``. The harness loads the module by path
(``harness.Bench.family``), so a new family is a new file, and everything
that depends on the model's structure goes through these functions:

- ``check_traffic(cfg, traffic)``: raises ``ValueError`` where the model
  does not take the split's ``dim`` features to ``classes`` classes;
- ``draw_weights(cfg, g, device)``: the seed's weights, drawn from the
  run's generator ``g`` on ``device`` before the split, in a few large
  calls;
- ``session_kwargs(cfg, traffic)``: the ``TrainingSession`` keyword
  arguments (the harness adds ``data_dir`` and ``device``);
- ``leaves(weights)``: the seed's weights as a list of tensors in the
  family's fixed order; ``state(session)``: the session's weights as host
  arrays in the same order. The check compares these lists leaf by leaf;
- ``checkpoint(cfg, traffic, leaves)``: the ``(meta, arrays)`` pair that
  ``TrainingSession.load_weights(verified=...)`` takes, from host arrays
  in that order (the seed's leaves, or a state the ``stale_state`` fault
  puts back);
- ``reference(weights, cfg, traffic)``: the plain reference's trainer,
  started from a copy of the seed's weights: ``.step(x, y)`` trains one
  batch and returns its loss as a float, ``.leaves()`` lists its weights in
  the family's order. It runs inside ``reference.mlp.matmul_precision``,
  and imports nothing of the port;
- ``train_flops_per_sample(cfg)``: the model FLOPs of one trained sample,
  the work the sample really does, for ``mfu.train``.
"""

DEFAULT = "mlp"
FUNCTIONS = (
    "check_traffic", "draw_weights", "session_kwargs", "leaves", "state", "checkpoint",
    "reference", "train_flops_per_sample",
)
