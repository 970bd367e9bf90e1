"""ShallowSpeed's MLP family: Linears ``(W, b)`` with relu between them and
the softmax-MSE head, as ``configs/<config>.json`` sizes it (``sizes``,
``activation``, ``optimizer``, ``lr``). Its leaves are ``W0, b0, W1, b1,
...``; its checkpoint names them ``w<i>``, ``b<i>``; its reference is
``reference/mlp.py``."""

from portbench.reference import mlp as reference_mlp
from portbench.work import bounds, inputs


def check_traffic(cfg, traffic):
    sizes = cfg["sizes"]
    if sizes[0] != traffic["dim"] or sizes[-1] != traffic["classes"]:
        raise ValueError(
            f"model {tuple(sizes)} does not take {traffic['dim']} features "
            f"to {traffic['classes']} classes"
        )


def draw_weights(cfg, g, device):
    return inputs.draw_weights(cfg["sizes"], g, device)


def session_kwargs(cfg, traffic):
    return dict(
        sizes=tuple(cfg["sizes"]),
        global_batch_size=traffic["global_batch_size"],
        mubatches=traffic["mubatches"],
        lr=cfg["lr"],
        optimizer=cfg["optimizer"],
        **traffic["session"],
    )


def leaves(weights):
    return [t for wb in weights for t in wb]


def state(session):
    """A session's ``params()`` (stages of ``{"W", "b"}`` layers) as
    leaves."""
    return [t for stage in session.params() for layer in stage for t in (layer["W"], layer["b"])]


def checkpoint(cfg, traffic, host):
    meta = {
        "sizes": list(cfg["sizes"]),
        "global_batch_size": traffic["global_batch_size"],
        "act": cfg["activation"],
    }
    arrays = {}
    for i in range(len(host) // 2):
        arrays[f"w{i}"], arrays[f"b{i}"] = host[2 * i], host[2 * i + 1]
    return meta, arrays


def reference(weights, cfg, traffic):
    return reference_mlp.Trainer(
        weights, cfg["lr"], traffic["global_batch_size"], traffic["mubatches"]
    )


def train_flops_per_sample(cfg):
    return bounds.mlp_train_flops_per_sample(cfg["sizes"])
