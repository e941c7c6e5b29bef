"""Small configurations of the benchmark's two architectures, for CPU tests:
the port's own builders at reduced sizes, registered under test names, and
the matching configuration dicts."""

from __future__ import annotations

import copy

import pytest

from benchmark import harness

VIT = "bench_test_vit"
SWIN = "bench_test_swin"


def _register():
    from noise_robust_vit_tpu_torch.models import factory, swin
    from noise_robust_vit_tpu_torch.models.simple_vit import SimpleViT

    if VIT not in factory._REGISTRY:
        @factory.register_model(VIT)
        def _vit(num_classes, image_size, robust, dtype, device=None, **kw):
            return SimpleViT(image_size=image_size, patch_size=4, num_classes=num_classes,
                             dim=128, depth=2, heads=2, mlp_dim=256, robust=robust,
                             dtype=dtype, device=device)

        @factory.register_model(SWIN)
        def _swin(num_classes, image_size, robust, dtype, device=None, **kw):
            return swin._swin([4, 4], 32, [2, 2], [2, 4], [4, 4], 0.2, 1,
                              num_classes=num_classes, robust=robust, dtype=dtype,
                              device=device)


def small_configs() -> dict:
    """Tiny versions of the two configuration files (same keys)."""
    _register()
    vit = copy.deepcopy(harness.load_config("simple_vit_b16"))
    vit.update(model=VIT, image_size=16, patch_size=4, dim=128, depth=2, heads=2,
               mlp_dim=256, num_classes=10, batch=32)
    for mode in vit["attention"].values():
        mode["calls"] = [dict(mode["calls"][0], batch=32, tokens=16, heads=2, count=2)]
    sw = copy.deepcopy(harness.load_config("swin_t"))
    sw.update(model=SWIN, image_size=32, embed_dim=32, depths=[2, 2], heads=[2, 4],
              window=4, num_classes=10, batch=24)
    sw["attention"]["sinkhorn"]["calls"] = [
        {"kind": "windowed", "windows_total": 96, "windows": 4, "heads": 2, "tokens": 16,
         "dim": 16, "count": 2},
        {"kind": "windowed", "windows_total": 24, "windows": 1, "heads": 4, "tokens": 16,
         "dim": 16, "count": 2}]
    return {"simple_vit_b16": vit, "swin_t": sw}


@pytest.fixture
def small(monkeypatch):
    """Point the harness's configuration lookup at the tiny configurations
    (by the real configurations' names), the reference in blocks of 8
    images, so that it sums its gradients over several (a model that
    couples the images of a batch keeps its batch whole)."""
    cfgs = small_configs()
    monkeypatch.setattr(harness, "load_config", lambda name: cfgs[name])
    monkeypatch.setattr(harness, "REFERENCE_BLOCK", 8)
    return cfgs
