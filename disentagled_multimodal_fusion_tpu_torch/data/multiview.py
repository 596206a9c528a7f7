"""Multi-view .mat datasets.

The port's own copy of the loaders of
``disentagled_multimodal_fusion_tpu/data/multiview.py`` (numpy and scipy
only); ``DATA_DIR`` is the repository's ``data/``.

Reference semantics: datasets/dataset.py:164-322. Views are per-feature
min-max scaled to [0,1] (or [-1,1]); labels shifted to 0-base; ``dims`` is a
(V, 1) array of per-view feature sizes. The UQ perturbations (noise and
conflict injection) come with the training slice.

Views are held as dense numpy arrays and shipped to the device once.
"""

from __future__ import annotations

from pathlib import Path
from typing import List

import numpy as np
import scipy.io as sio

DATA_DIR = Path(__file__).resolve().parent.parent.parent / "data"


def minmax_scale(x: np.ndarray, feature_range=(0, 1)) -> np.ndarray:
    """Per-feature min-max scaling matching sklearn.MinMaxScaler
    (zero-range features get scale 1)."""
    lo, hi = feature_range
    dmin = x.min(axis=0)
    dmax = x.max(axis=0)
    drange = dmax - dmin
    drange[drange == 0.0] = 1.0
    scale = (hi - lo) / drange
    return (x - dmin) * scale + lo


class MultiViewDataset:
    """V views of shape (N, S_v) + labels."""

    def __init__(self, data_name: str, data_x, data_y, norm_min: int = 0):
        self.data_name = data_name
        self.num_views = data_x.shape[0]
        frange = (0, 1) if norm_min == 0 else (-1, 1)
        self.X: List[np.ndarray] = [
            minmax_scale(np.asarray(data_x[v], dtype=np.float64), frange).astype(
                np.float32
            )
            for v in range(self.num_views)
        ]
        y = np.squeeze(np.asarray(data_y))
        if y.min() == 1:
            y = y - 1
        self.Y = y.astype(np.int64)
        self.num_classes = len(np.unique(self.Y))
        self.dims = np.array([[self.X[v].shape[1]] for v in range(self.num_views)])

    def __len__(self) -> int:
        return len(self.X[0])

    def arrays(self):
        """(views tuple, labels) as dense arrays for device upload."""
        return tuple(self.X), self.Y


# ---------------- factory loaders (dataset.py:273-322) ----------------
def _load(path: str):
    full = DATA_DIR / path
    if not full.exists():
        raise FileNotFoundError(
            f"{full} missing — copy the reference's data/*.mat files "
            f"(Caltech101-20.mat is absent from the reference snapshot too)."
        )
    return sio.loadmat(str(full))


def HandWritten() -> MultiViewDataset:
    """6 views: 240/76/216/47/64/6, N=2000, 10 classes."""
    data = _load("handwritten.mat")
    return MultiViewDataset("HandWritten", data["X"][0], data["Y"])


def Scene() -> MultiViewDataset:
    """3 views (transposed): 20/59/40, N=4485, 15 classes."""
    data = _load("scene15_mtv.mat")
    x = data["X"][0]
    for v in range(len(x)):
        x[v] = x[v].T
    return MultiViewDataset("Scene", x, data["gt"])


def PIE() -> MultiViewDataset:
    """3 views (transposed): 484/256/279, N=680, 68 classes."""
    data = _load("PIE_face_10.mat")
    x = data["X"][0]
    for v in range(len(x)):
        x[v] = x[v].T
    return MultiViewDataset("PIE", x, data["gt"])


def Caltech() -> MultiViewDataset:
    """6 views; the .mat is missing from the reference snapshot
    (.MISSING_LARGE_BLOBS)."""
    data = _load("Caltech101-20.mat")
    return MultiViewDataset("Caltech", data["X"].squeeze(), data["Y"])


def CUB() -> MultiViewDataset:
    """2 views: 1024/300, N=600, 10 classes (labels stored 1-based twice:
    loader subtracts 1, normalize() re-checks)."""
    data = _load("cub_googlenet_doc2vec_c10.mat")
    return MultiViewDataset("CUB", data["X"][0], data["gt"] - 1)


DATASET_REGISTRY = {
    "HandWritten": HandWritten,
    "Scene": Scene,
    "PIE": PIE,
    "CalTech": Caltech,
    "CUB": CUB,
}
