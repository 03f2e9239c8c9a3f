"""The backbones: ``PonitaFiberBundle`` (``models/ponita.py``) and the
point-cloud ``PonitaPointCloud`` (``models/point_cloud.py``), and
:func:`make_ponita`, which picks one by ``num_ori`` as the JAX package's
``arreau_tpu/models/__init__.py`` does."""

from arreau_tpu_torch.models.point_cloud import PointCloudConfig, PonitaPointCloud
from arreau_tpu_torch.models.ponita import PonitaConfig, PonitaFiberBundle


def make_ponita(num_ori: int = 16, **kwargs):
    """``num_ori > 0``: ``PonitaFiberBundle`` on a grid of ``num_ori``
    orientations; ``-1``: the lifted ``PonitaPointCloud``; ``0``: the plain
    ``PonitaPointCloud``. ``kwargs`` are the fields of ``PonitaConfig`` or
    ``PointCloudConfig``."""
    if num_ori > 0:
        return PonitaFiberBundle(PonitaConfig(num_ori=num_ori, **kwargs))
    return PonitaPointCloud(PointCloudConfig(lifted=num_ori == -1, **kwargs))
