"""Data layer: a copy of ``shallowspeed_tpu/data.py`` (it imports no JAX,
but the port imports nothing of the JAX package).

MNIST-784-format splits on disk: ``x_{train,val}.npy`` (or ``.parquet``,
read with pandas only when that file exists) and ``y_{train,val}.npy``
one-hot targets. Same drop-last to a multiple of the global batch size,
same strided DP shard ``X[rank : full : size]`` with a contiguous copy,
same microbatch slicing arithmetic and divisibility checks as the
reference, and deliberately NO shuffling: determinism is part of the
correctness story. ``epoch_arrays()`` gives the whole local shard as
``(num_batches, M, mubatch, dim)`` host arrays in sequential microbatch
order, which the trainer moves to the device once.
"""

import os
from pathlib import Path

import numpy as np


def _read_features(save_dir: Path, suffix: str) -> np.ndarray:
    pq = save_dir / f"x_{suffix}.parquet"
    npy = save_dir / f"x_{suffix}.npy"
    if pq.exists():
        import pandas as pd

        return pd.read_parquet(pq).to_numpy(dtype=np.float32)
    if npy.exists():
        return np.load(npy).astype(np.float32)
    raise FileNotFoundError(
        f"No features found at {pq} or {npy}. Run `python prepare_data.py` first."
    )


class Dataset:
    """One split (train or val) of the MNIST-784-format dataset.
    ``mubatch_size`` is the per-DP-replica microbatch and must divide the
    local batch ``global_batch_size // DP_size``."""

    def __init__(self, save_dir, global_batch_size, mubatch_size, validation=False):
        self.save_dir = Path(save_dir)
        if not self.save_dir.is_dir():
            raise FileNotFoundError(
                f"{self.save_dir} is not a directory — run `python prepare_data.py`"
            )
        self.global_batch_size = int(global_batch_size)
        self.mubatch_size = int(mubatch_size)
        self.local_batch_size = None
        self._val = validation
        self.input_X = None
        self.target_y = None

    def load(self, DP_rank=0, DP_size=1):
        if not (0 <= DP_rank < DP_size):
            raise ValueError(f"DP_rank {DP_rank} out of range for DP_size {DP_size}")
        if self.global_batch_size % DP_size != 0:
            raise ValueError("global batch size must be divisible by DP size")
        self.local_batch_size = self.global_batch_size // DP_size
        if self.local_batch_size % self.mubatch_size != 0:
            raise ValueError("microbatch size must divide the local batch size")

        suffix = "val" if self._val else "train"
        X = _read_features(self.save_dir, suffix)
        y = np.load(self.save_dir / f"y_{suffix}.npy").astype(np.float32)
        if len(X) != len(y):
            raise ValueError("feature/target length mismatch")

        # drop-last so every batch is exactly global_batch_size long
        self.raw_len = len(X)  # pre-drop-last size, for diagnostics
        full = len(X) - (len(X) % self.global_batch_size)
        # strided DP shard; contiguous copy for clean host->device transfers
        self.input_X = np.ascontiguousarray(X[DP_rank:full:DP_size])
        self.target_y = np.ascontiguousarray(y[DP_rank:full:DP_size])

    def _require_loaded(self):
        if self.input_X is None:
            raise RuntimeError("Dataset not loaded — call .load(DP_rank, DP_size) first")

    def __len__(self):
        self._require_loaded()
        return len(self.input_X)

    def _mubatch_slice(self, batch_id, mubatch_id):
        self._require_loaded()
        assert batch_id < self.get_num_batches()
        assert mubatch_id < self.get_num_mubatches()
        start = batch_id * self.local_batch_size + mubatch_id * self.mubatch_size
        return slice(start, start + self.mubatch_size)

    def load_micro_batch_input(self, batch_id, mubatch_id):
        return self.input_X[self._mubatch_slice(batch_id, mubatch_id)]

    def load_micro_batch_target(self, batch_id, mubatch_id):
        return self.target_y[self._mubatch_slice(batch_id, mubatch_id)]

    def get_num_batches(self):
        return len(self) // self.local_batch_size

    def get_num_mubatches(self):
        return self.local_batch_size // self.mubatch_size

    def epoch_arrays(self):
        """Whole local shard as (num_batches, M, mubatch, dim) fp32 arrays,
        rows in sequential microbatch order."""
        self._require_loaded()
        nb, M, mb = self.get_num_batches(), self.get_num_mubatches(), self.mubatch_size
        X = self.input_X[: nb * self.local_batch_size]
        y = self.target_y[: nb * self.local_batch_size]
        return (
            X.reshape(nb, M, mb, X.shape[-1]),
            y.reshape(nb, M, mb, y.shape[-1]),
        )


def default_data_dir() -> Path:
    return Path(os.environ.get("SHALLOWSPEED_DATA_DIR", "data/mnist_784"))
