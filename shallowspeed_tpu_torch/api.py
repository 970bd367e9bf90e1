"""High-level API: the serving subset of ``shallowspeed_tpu.api.TrainingSession``.

    from shallowspeed_tpu_torch.api import TrainingSession

    run = TrainingSession()                     # flagship MLP on the GPU
    probs = run.predict(x)                      # (n, 784) numpy -> (n, 10)

The sequential layout only (dp = pp = tp = 1): weights from the
deterministic init or a checkpoint (``resume=``, any layout's snapshot),
and ``predict`` exactly as the JAX session's sequential branch — rows
packed into fixed ``slot_rows``-row slots, one slot-shaped forward per
OCCUPIED slot. A fixed slot shape is what makes a request's rows give the
same bits whatever rides beside them, which the serving engine's
"response == direct predict()" contract needs. Training (and loading a
training split) comes with the next slice.
"""

import numpy as np
import torch

from shallowspeed_tpu_torch import convert, resolve_device, trainer
from shallowspeed_tpu_torch import model as Mo
from shallowspeed_tpu_torch.checkpoint import load_checkpoint
from shallowspeed_tpu_torch.serving import slots as serving_slots

# The reference's canonical configuration.
FLAGSHIP_SIZES = (784, 128, 127, 126, 125, 124, 123, 10)
FLAGSHIP_BATCH = 128


class TrainingSession:
    """A model's weights on one device, served through slot-shaped forwards.

    ``sizes``/``model``: the layer sizes, or a ``MODEL_ZOO`` name that
    overrides them. ``global_batch_size`` scales the (future) loss and is
    kept in the spec, as in the JAX package. ``precision``: only
    ``"highest"`` (IEEE fp32) exists on this port. ``resume``: a checkpoint
    path to serve. ``predict_slot_rows``/``predict_slot_ladder``: the slot
    geometry (``serving/slots.py``). ``device``: ``"cuda"`` (default) or
    ``"cpu"``; a missing GPU raises, it never falls back."""

    def __init__(
        self,
        sizes=FLAGSHIP_SIZES,
        model=None,
        global_batch_size=FLAGSHIP_BATCH,
        precision="highest",
        resume=None,
        predict_slot_rows=None,
        predict_slot_ladder=None,
        device=None,
    ):
        self.device = resolve_device(device)
        if precision == "default":
            raise ValueError(
                "precision='default' (the TPU's bf16-input MXU passes) has no "
                "counterpart in the port yet; it computes in IEEE fp32 "
                "(precision='highest') — see ROADMAP.md, Parity rules"
            )
        if precision != "highest":
            raise ValueError(f"precision must be 'highest', got {precision!r}")
        if model is not None:
            sizes, act = Mo.resolve_model(model)
        else:
            act = "relu"
        self.B = int(global_batch_size)
        self.spec = Mo.make_model_spec(sizes, 1, self.B, act=act)
        if resume is not None:
            host_params, loaded_spec, _ = load_checkpoint(resume, 1, self.B)
            self._check_compatible(loaded_spec, "the requested model")
            self.spec = loaded_spec
        else:
            host_params = Mo.init_model(self.spec)
        self._params = convert.params_from_numpy(host_params, self.device)
        if predict_slot_rows is None:
            self._slot_rows = serving_slots.default_slot_rows(1)
        else:
            self._slot_rows = int(predict_slot_rows)
            if self._slot_rows < 1:
                raise ValueError(
                    f"predict_slot_rows must be positive, got {predict_slot_rows}"
                )
        self._slot_ladder = serving_slots.validate_ladder(
            predict_slot_ladder
            if predict_slot_ladder is not None
            else serving_slots.DEFAULT_SLOT_LADDER
        )
        self._predict = trainer.make_predict(self.spec)

    def _check_compatible(self, loaded_spec, what):
        if tuple(loaded_spec.sizes) != tuple(self.spec.sizes):
            raise ValueError(
                f"checkpoint sizes {loaded_spec.sizes} do not match {what}'s "
                f"sizes {self.spec.sizes}"
            )
        if loaded_spec.act != self.spec.act:
            raise ValueError(
                f"checkpoint activation family {loaded_spec.act!r} does not "
                f"match {what}'s {self.spec.act!r}"
            )

    @property
    def slot_rows(self):
        """Rows per inference slot."""
        return self._slot_rows

    @property
    def slot_ladder(self):
        """Allowed slot counts per dispatch; the top rung caps a chunk."""
        return self._slot_ladder

    def predict(self, x):
        """Softmax class probabilities for an ``(n, in_dim)`` batch (host
        numpy in, host numpy out). Rows are padded to whole ``slot_rows``
        slots in chunks of at most the top rung's slots, and each occupied
        slot runs one forward of the fixed slot shape."""
        x = np.asarray(x, np.float32)
        if x.ndim != 2 or x.shape[1] != self.spec.in_dim:
            raise ValueError(
                f"predict takes (n, {self.spec.in_dim}) rows, got {x.shape}"
            )
        n = x.shape[0]
        out_dim = self.spec.out_dim
        if n == 0:
            return np.zeros((0, out_dim), np.float32)
        S_rows = self._slot_rows
        cap = self._slot_ladder[-1] * S_rows  # rows per ladder-capped chunk
        outs = []
        for i in range(0, n, cap):
            chunk = x[i : i + cap]
            m = serving_slots.slots_needed(chunk.shape[0], S_rows)
            xb = np.pad(chunk, ((0, m * S_rows - chunk.shape[0]), (0, 0)))
            xd = torch.from_numpy(xb).to(self.device)
            preds = torch.cat(
                [
                    self._predict(self._params, xd[k * S_rows : (k + 1) * S_rows])
                    for k in range(m)
                ],
                dim=0,
            )
            outs.append(preds[: chunk.shape[0], :out_dim].cpu().numpy())
        return np.concatenate(outs, axis=0)

    def inference_latency_bound(self):
        """The analytical latency floor of one slot. Not known on this card
        yet: the JAX cost model's peaks are TPU numbers and are not carried
        over, so ``seconds`` is None with source ``"unmeasured"``."""
        return {"seconds": None, "ticks": None, "peak_source": "unmeasured"}

    def params(self):
        """Logical per-stage params (host numpy), the JAX pytree layout."""
        return convert.params_to_numpy(self._params)

    def load_weights(self, path):
        """Swap this session's weights from a checkpoint between dispatches.
        The checkpoint must have this session's sizes and activation family.
        Returns the metadata; unreadable or corrupt files raise
        ``CheckpointError`` before any state changes."""
        host_params, loaded_spec, meta = load_checkpoint(path, 1, self.B)
        self._check_compatible(loaded_spec, "this session")
        self._params = convert.params_from_numpy(host_params, self.device)
        return meta
