"""The frozen counts: the denoiser's convolutions, the bounds, and the
segments the cells' frames trace."""

from __future__ import annotations

import pytest

from benchmark import common
from benchmark.counts import ops
from benchmark.reference import camera as ref_camera
from benchmark.reference import tracer


def test_conv_operations():
    assert ops.conv_operations(1, 512, 512) == 15_724_237_312  # one 512x512 forward
    assert 3 * ops.conv_operations(5, 256, 256) == 58_965_889_920  # a training step


def test_bound():
    # K1 at 512x512x32: 41,943,040 segments x 568 operations at 67 TFLOP/s
    assert ops.bound_ms(ops.nominal_segments(512, 512, 32, 5), 568.0) == pytest.approx(0.35557, rel=1e-4)


@pytest.mark.parametrize("config,pose", [
    ("cornell-diffuse", (50.0, 52.0, 295.6, -90.0, 0.0)),  # the viewer's start
    ("cornell-diffuse", (72.9296, 52.9104, 287.5195, -71.1299, 1.4191)),  # a collected pose
    ("cornell-nee", (50.0, 52.0, 295.6, -90.0, 0.0)),  # the geometry case
])
def test_no_path_escapes_the_box(config, pose):
    """The box is closed: every path hits at every bounce, so the traced
    segments are the nominal W x H x spp x bounces the metrics use."""
    c = common.load_json("configs", config)
    p = ref_camera.Pose(pose[:3], pose[3], pose[4])
    fr = tracer.Frame(common.spheres(c), p.position, p.corner_rays(24, 24), 24, 24, 7, 3,
                      range(24), light=8 if c["render"]["nee"] else None)
    assert ops.segments(fr, 4) == ops.nominal_segments(24, 24, 4, 5)
