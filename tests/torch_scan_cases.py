"""The selective-scan kernels' card-test shapes, shared by the card tests
(``test_torch_gpu_kernels.py``) and the CPU tests of their launch plan
(``test_torch_selective_scan.py``). Import as ``import torch_scan_cases``
(pytest puts tests/ on sys.path)."""

# (b, s, d, n, chunk): the Mamba tiny and 130m widths at short lengths, a
# ragged s, d no multiple of the 32-channel tile, n 8 and 4, a chunk of
# 320 (more than a time tile), a chunk longer than s, and the smallest
# shapes (one step, one channel, one state; chunks of 2), and 32 states
# (two blocks of 16 through ``split_scan_*``); then s spanning several
# time tiles with a ragged tail (1000 + a 64-step tile - 1), one long
# sequence (b 1, s 8192: 48 channel tiles, split along time across a
# cluster), a chunk of 100 (no multiple of a thread's 8 steps or of a
# tile) and d 33, one lane past a channel tile; and the Mamba-130m train
# shape itself, whose card plans (one rank forward, a few warps backward)
# the smaller shapes do not all take
SCAN_CASES = [(2, 256, 128, 8, 32), (2, 256, 1536, 16, 128),
              (1, 200, 200, 16, 64), (2, 300, 96, 8, 128),
              (1, 512, 64, 4, 320), (1, 130, 64, 16, 1000),
              (1, 1, 1, 1, 128), (3, 5, 70, 3, 2), (2, 256, 128, 32, 32),
              (2, 1063, 1536, 16, 128), (1, 8192, 1536, 16, 128),
              (2, 512, 256, 16, 100), (2, 256, 33, 16, 64),
              (4, 1024, 1536, 16, 128)]

# the Mamba-130m train shape: batch 4 x seq 1024, d_inner 1536, 16 states
TRAIN_SHAPE = SCAN_CASES[-1]
