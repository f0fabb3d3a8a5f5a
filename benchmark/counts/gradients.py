"""Operation counts of the inverse cells' kernels that ``ops.py`` lacks, frozen.

Counted operations of one path segment (9 spheres, 5 bounces; a multiply
and an add as two), by ``scripts/torch_count_ops.py`` on the port's plain
versions, with the rules of ``ops.py``:

- ``color_nee_glossy``: K1's NEE glossy colour instance (the glossy inverse
  step's two colour passes): the untaped forward of
  ``count_sweep("glossy", nee=True, aov=False)`` (its ``forward_untaped``);
- ``ad_nee_glossy_color``: K4 against a colour cotangent under NEE glossy
  (the glossy inverse step's two replays): the taped forward 972.0 and the
  sweep 357.2 (``pathtrace_tpu_torch/utils/roofline.py::OPS_PER_SEGMENT``);
- ``grad_dump``: K2's dump mode (the albedo step's two launches), counted
  as its fused mode, ``grad_fused``: the forward 562.8 and the product-chain
  sweep 42.8 with its cotangent-free accumulators.
"""

from __future__ import annotations

OPS_PER_SEGMENT = {
    "color_nee_glossy": 962.0,  # K1
    "ad_nee_glossy_color": 1329.2,  # K4
    "grad_dump": 605.6,  # K2
}
