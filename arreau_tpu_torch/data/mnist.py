"""MNIST superpixel data: SLIC clustering over raw idx files with a
synthetic rasterised-digit fallback; a numpy copy of
``arreau_tpu/data/mnist.py`` (the port imports nothing of the JAX package).

75 SLIC superpixels per 28x28 image (centroid position and mean
intensity), then Sparsify (intensity > 0.5) and RemoveDuplicatePoints. When
the raw MNIST idx files are present they are clustered directly; otherwise
synthetic digit-like stroke images go through the same pipeline.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import NamedTuple

import numpy as np


class Mnist2DExamples(NamedTuple):
    pos: np.ndarray  # [S, N, 2]
    value: np.ndarray  # [S, N]
    mask: np.ndarray  # [S, N]
    label: np.ndarray  # [S]

    def __len__(self):
        return len(self.pos)


def _read_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        _zero, _dtype_code, ndim = struct.unpack(">HBB", f.read(4))
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(dims)


def load_mnist_idx(
    data_dir: str, split: str = "train", num_nodes: int = 75, limit: int | None = None
) -> Mnist2DExamples:
    prefix = "train" if split == "train" else "t10k"
    img_path = None
    for cand in (f"{prefix}-images-idx3-ubyte", f"{prefix}-images-idx3-ubyte.gz"):
        p = os.path.join(data_dir, cand)
        if os.path.exists(p):
            img_path = p
            break
    if img_path is None:
        raise FileNotFoundError(f"no MNIST idx files under {data_dir}")
    lbl_path = img_path.replace("images-idx3", "labels-idx1")
    images = _read_idx(img_path)[:limit]
    labels = _read_idx(lbl_path)[:limit]

    S = len(images)
    pos = np.zeros((S, num_nodes, 2), np.float32)
    val = np.zeros((S, num_nodes), np.float32)
    mask = np.zeros((S, num_nodes), bool)
    for s in range(S):
        img = images[s].astype(np.float32) / 255.0
        flat = img.ravel()
        top = np.argsort(-flat)[:num_nodes]
        keep = flat[top] > 0
        ys, xs = np.divmod(top, img.shape[1])
        n = keep.sum()
        pos[s, :n] = np.stack([xs[keep], 27 - ys[keep]], -1)
        val[s, :n] = flat[top][keep]
        mask[s, :n] = True
    return Mnist2DExamples(pos=pos, value=val, mask=mask, label=labels.astype(np.int32))


def slic_superpixels(
    img: np.ndarray,
    n_segments: int = 75,
    compactness: float = 0.25,
    n_iter: int = 10,
) -> tuple[np.ndarray, np.ndarray]:
    """SLIC superpixels of one grayscale image in [0, 1].

    Standard SLIC (Achanta et al. 2012): k-means in (intensity, x/S, y/S)
    space with spatial scale S = sqrt(HW/k) and compactness weighting; the
    28x28 images are small enough for full (not windowed) assignments.

    Returns (centroids ``[k, 2]`` as (x, y_flipped) like the PyG dataset's
    coordinate convention, mean intensities ``[k]``); empty clusters are
    dropped.
    """
    H, W = img.shape
    S = float(np.sqrt(H * W / n_segments))
    ys = np.arange(S / 2, H, S)
    xs = np.arange(S / 2, W, S)
    cy, cx = np.meshgrid(ys, xs, indexing="ij")
    centers = np.stack([cy.ravel(), cx.ravel()], -1)  # [k, 2] (y, x)
    cint = img[
        np.clip(centers[:, 0].astype(int), 0, H - 1),
        np.clip(centers[:, 1].astype(int), 0, W - 1),
    ].astype(np.float64)

    py, px = np.mgrid[0:H, 0:W]
    pix = np.stack([py.ravel(), px.ravel()], -1).astype(np.float64)  # [HW, 2]
    pint = img.ravel().astype(np.float64)

    assign = None
    for _ in range(n_iter):
        d_int = (pint[:, None] - cint[None, :]) ** 2
        d_xy = ((pix[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
        assign = (d_int + d_xy / S**2 * compactness**2).argmin(1)
        for k in range(len(centers)):
            sel = assign == k
            if sel.any():
                centers[k] = pix[sel].mean(0)
                cint[k] = pint[sel].mean()
    keep = np.array([np.any(assign == k) for k in range(len(centers))])
    centers, cint = centers[keep], cint[keep]
    # (x, y) with y flipped to match the image-to-cartesian convention
    pos = np.stack([centers[:, 1], (H - 1) - centers[:, 0]], -1)
    return pos.astype(np.float32), cint.astype(np.float32)


def superpixel_examples(
    images: np.ndarray,
    labels: np.ndarray,
    num_nodes: int = 75,
    threshold: float = 0.5,
) -> Mnist2DExamples:
    """Images [S, H, W] in [0,1] -> sparsified, deduplicated superpixel clouds
    (the reference's MNISTSuperpixels -> Sparsify -> RemoveDuplicatePoints
    pipeline, main_mnist.py:17-45)."""
    S = len(images)
    pos = np.zeros((S, num_nodes, 2), np.float32)
    val = np.zeros((S, num_nodes), np.float32)
    mask = np.zeros((S, num_nodes), bool)
    for s in range(S):
        p, v = slic_superpixels(images[s], n_segments=num_nodes)
        sel = v > threshold  # Sparsify
        p, v = p[sel], v[sel]
        if len(p) > 1:  # RemoveDuplicatePoints (keep first of coincident)
            d = np.linalg.norm(p[:, None] - p[None, :], axis=-1)
            d += 100.0 * np.tril(np.ones_like(d))
            keep = d.min(1) > 0.0
            p, v = p[keep], v[keep]
        n = min(len(p), num_nodes)
        pos[s, :n], val[s, :n], mask[s, :n] = p[:n], v[:n], True
    return Mnist2DExamples(pos=pos, value=val, mask=mask, label=labels.astype(np.int32))


def load_mnist_superpixels(
    data_dir: str, split: str = "train", num_nodes: int = 75, limit: int | None = None
) -> Mnist2DExamples:
    """Raw idx files -> SLIC superpixel clouds (reference input distribution)."""
    raw = load_mnist_idx(data_dir, split, num_nodes=1, limit=limit)  # only labels used
    # re-read images directly (load_mnist_idx returns clouds, not rasters)
    prefix = "train" if split == "train" else "t10k"
    for cand in (f"{prefix}-images-idx3-ubyte", f"{prefix}-images-idx3-ubyte.gz"):
        p = os.path.join(data_dir, cand)
        if os.path.exists(p):
            images = _read_idx(p)[:limit].astype(np.float32) / 255.0
            break
    return superpixel_examples(images, raw.label, num_nodes=num_nodes)


def synthetic_digit_images(
    num: int, seed: int = 0, num_classes: int = 10, size: int = 28
) -> tuple[np.ndarray, np.ndarray]:
    """Digit-like stroke rasters: each class is a fixed random polyline
    template drawn with a soft (gaussian) brush + per-sample jitter. Classes
    are distinguishable by stroke geometry, like digits."""
    rng = np.random.default_rng(seed)
    templates = rng.uniform(5, size - 5, size=(num_classes, 6, 2))
    labels = rng.integers(0, num_classes, size=num)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64)
    images = np.zeros((num, size, size), np.float32)
    for s in range(num):
        pts = templates[labels[s]] + rng.normal(scale=0.6, size=(6, 2))
        img = np.zeros((size, size))
        for a, b in zip(pts[:-1], pts[1:]):
            for t in np.linspace(0, 1, 12):
                c = a * (1 - t) + b * t
                img += np.exp(-(((yy - c[1]) ** 2 + (xx - c[0]) ** 2) / 1.2))
        images[s] = np.clip(img, 0, 1)
    return images, labels.astype(np.int32)


def synthetic_superpixels(
    num: int, seed: int = 0, num_nodes: int = 75, num_classes: int = 10
) -> Mnist2DExamples:
    """Synthetic stroke images pushed through the SAME SLIC pipeline as real
    MNIST — the offline stand-in with the reference's input distribution."""
    images, labels = synthetic_digit_images(num, seed=seed, num_classes=num_classes)
    return superpixel_examples(images, labels, num_nodes=num_nodes)


def synthetic_shapes(
    num: int, seed: int = 0, num_nodes: int = 32, num_classes: int = 10
) -> Mnist2DExamples:
    """Ten fixed random shape templates + jitter; rotation-invariant
    classification remains learnable (distances within template preserved)."""
    rng = np.random.default_rng(seed)
    templates = rng.uniform(0, 10, size=(num_classes, num_nodes, 2))
    labels = rng.integers(0, num_classes, size=num)
    pos = templates[labels] + rng.normal(scale=0.1, size=(num, num_nodes, 2))
    # random global rotation per sample (classes must be recognized by geometry)
    theta = rng.uniform(0, 2 * np.pi, size=num)
    c, s = np.cos(theta), np.sin(theta)
    rot = np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], -2)
    pos = np.einsum("bij,bnj->bni", rot, pos)
    value = rng.uniform(0.6, 1.0, size=(num, num_nodes)).astype(np.float32)
    mask = np.ones((num, num_nodes), bool)
    return Mnist2DExamples(
        pos=pos.astype(np.float32), value=value, mask=mask, label=labels.astype(np.int32)
    )
