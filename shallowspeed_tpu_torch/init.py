"""Deterministic, layout-independent parameter initialization.

A copy of ``shallowspeed_tpu/init.py``: a fresh MT19937 stream per Linear
layer, seeded from its (in, out) dims, in host NumPy. The expression is the
reference's verbatim (normal -> astype(float32) -> divide by the float64
``np.sqrt(in)``), so the port's weights are bitwise equal to the JAX
package's and a model hash does not depend on which package made them.
"""

import numpy as np


def linear_init(in_dim: int, out_dim: int):
    """Weights N(0,1)/sqrt(in) fp32 with per-layer seed in + 1337*out; zero bias."""
    rs = np.random.RandomState(
        np.random.MT19937(np.random.SeedSequence(in_dim + out_dim * 1337))
    )
    w = rs.normal(0.0, 1.0, size=(out_dim, in_dim)).astype(np.float32) / np.sqrt(
        in_dim
    )
    b = np.zeros((1, out_dim), dtype=np.float32)
    return np.asarray(w, dtype=np.float32), b
