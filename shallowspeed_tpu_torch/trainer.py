"""Trainer layer: the counterpart of ``shallowspeed_tpu/trainer.py``.

Only ``make_predict`` is ported in this slice (the serving path); the
training step, epoch and run come with the training slice.
"""

from shallowspeed_tpu_torch.model import ModelSpec, model_forward


def make_predict(spec: ModelSpec):
    """Inference: softmax predictions for a (batch, in_dim) tensor. PyTorch
    runs eagerly, so there is nothing to compile; the returned function is
    the forward with its residuals dropped."""

    def predict(params, x):
        out, _ = model_forward(params, spec, x)
        return out

    return predict
