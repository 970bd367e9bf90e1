"""The inputs of a run, made from its seed: the weights and the split.

Both come from one ``torch.Generator`` on the run's device, seeded with the
run's seed, in a few large calls: first the weights, by the configuration's
family (the MLP's ``draw_weights``: every weight as one flat draw), then
the split. The same seed on the same device gives the same tensors, so the
weights can be drawn again for the reference after the program is freed.

The split follows the law of ``chip_smoke.write_split``: Gaussian class
centres, each row its class's centre plus Gaussian noise, scaled from
``[-offset, span - offset]`` into ``[0, 1]`` and clipped; one-hot targets.
It is drawn on the device instead of with NumPy's legacy generator, which
takes seeds below 2**32 only and draws some tens of millions of normals
slowly on the host. The weights follow the port's init law
(``init.linear_init``): ``N(0, 1) / sqrt(in)``, zero bias.
"""

import math

import numpy as np
import torch


def generator(seed, device):
    """A generator on ``device`` seeded with ``seed`` (any whole number up to
    2**64 - 1)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def draw_weights(sizes, g, device):
    """``[(W, b)]`` of the MLP ``sizes``: W ``(out, in)`` ``N(0, 1) /
    sqrt(in)`` in float32, b ``(1, out)`` zeros, from one flat draw."""
    shapes = [(o, i) for i, o in zip(sizes[:-1], sizes[1:])]
    flat = torch.randn(sum(o * i for o, i in shapes), generator=g, device=device)
    out, off = [], 0
    for o, i in shapes:
        w = flat[off : off + o * i].view(o, i) / math.sqrt(i)
        out.append((w, torch.zeros((1, o), device=device)))
        off += o * i
    return out


def draw_rows(traffic, n, g, device, centers):
    """``n`` rows of the split's law: (x ``(n, dim)``, one-hot y)."""
    labels = torch.randint(0, traffic["classes"], (n,), generator=g, device=device)
    noise = torch.randn((n, traffic["dim"]), generator=g, device=device)
    x = centers[labels] + traffic["noise_std"] * noise
    x = ((x + traffic["offset"]) / traffic["span"]).clamp_(0.0, 1.0)
    y = torch.nn.functional.one_hot(labels, traffic["classes"]).to(torch.float32)
    return x, y


def make_inputs(draw, traffic, seed, device):
    """The run's weights and split from ``seed``: ``(weights, (x_train,
    y_train, x_val, y_val))``, every tensor on ``device``. ``draw(g,
    device)`` draws the model's weights from the generator first (a
    family's ``draw_weights`` with its configuration bound)."""
    g = generator(seed, device)
    weights = draw(g, device)
    centers = traffic["center_std"] * torch.randn(
        (traffic["classes"], traffic["dim"]), generator=g, device=device
    )
    train = draw_rows(traffic, traffic["train_rows"], g, device, centers)
    val = draw_rows(traffic, traffic["val_rows"], g, device, centers)
    return weights, train + val


def weights_again(draw, seed, device):
    """The run's weights drawn a second time from ``seed``."""
    return draw(generator(seed, device), device)


def write_split(path, split):
    """The split as the port reads it: ``x_{train,val}.npy``,
    ``y_{train,val}.npy`` under ``path``."""
    for name, t in zip(("x_train", "y_train", "x_val", "y_val"), split):
        np.save(path / f"{name}.npy", t.cpu().numpy())
