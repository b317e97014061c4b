"""The GroupNorm kernels' card-test shapes, shared by the card tests
(``test_torch_gpu_kernels.py``) and the CPU tests of their launch plan
(``test_torch_group_norm.py``). Import as ``import torch_gn_cases``
(pytest puts tests/ on sys.path)."""

import torch

# (n, h, w, c, groups, dtype, activation): UNet sites, an odd split, one
# group of 2048 channels (more than one CTA's 256 threads of vectors), a
# shape over the JAX kernel's VMEM budget, one pixel, and one channel per
# group; then a ragged hw of 1000 split across a cluster (125 rows a
# rank), c 1920 (cg 60), and the over-budget shape in float32 and without
# the SiLU, where the tile does not fit shared memory and later passes
# re-read device memory; then slabs of more groups than the CTA has
# threads (one pixel with c 48 in 48 groups: a slab of 48 groups, 32
# threads; c 296 in 296 groups, whose only slab of whole 8-element
# vectors is all 296 channels). The plans take clusters of 1 (one pixel),
# 2, 4 and 8 ranks (c 320 at 32 x 32); tests/test_torch_group_norm.py
# checks that each occurs under the modelled occupancy (the card's own
# answers may move a shape to a neighbouring size).
GN_CASES = [(1, 1, 1, 64, 32, torch.float32, "silu"),
            (2, 3, 1, 64, 64, torch.bfloat16, None),
            (4, 32, 32, 320, 32, torch.bfloat16, "silu"),
            (4, 8, 8, 1280, 32, torch.bfloat16, None),
            (2, 4, 4, 2560, 32, torch.float16, "silu"),
            (2, 16, 16, 640, 32, torch.float32, "silu"),
            (1, 3, 5, 30, 3, torch.bfloat16, None),
            (1, 2, 3, 4096, 2, torch.float32, "silu"),
            (1, 128, 128, 1024, 32, torch.bfloat16, "silu"),
            (2, 25, 40, 640, 32, torch.bfloat16, "silu"),
            (2, 25, 40, 640, 32, torch.float32, None),
            (4, 16, 16, 1920, 32, torch.bfloat16, "silu"),
            (4, 16, 16, 1920, 32, torch.float32, None),
            (1, 128, 128, 1024, 32, torch.float32, "silu"),
            (1, 128, 128, 1024, 32, torch.bfloat16, None),
            (1, 1, 1, 48, 48, torch.bfloat16, "silu"),
            (1, 4, 4, 296, 296, torch.bfloat16, None)]
