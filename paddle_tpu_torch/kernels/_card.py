"""The H100's limits that the kernels' launch plans share
(``group_norm.py: _launch_plan``, ``selective_scan.py: _scan_plan``).

A planner scores candidate geometries by how many clusters of each the
card holds at once. On the card it asks the kernels' library
(cudaOccupancyMaxActiveClusters through a kernel's ``pt_*_plan`` entry,
``held_clusters``) and reads the card's SM count (``sm_count``); where
there is no card, as in the CPU tests, ``clusters_model`` stands in.
"""

from __future__ import annotations

import ctypes

import torch

SMEM_LIMIT = 227 * 1024  # a CTA's dynamic shared memory
SMS = 132                # streaming multiprocessors of an H100 SXM


def clusters_model(threads: int, smem: int, ranks: int, sms: int = SMS) -> int:
    """How many clusters of ``ranks`` CTAs of ``threads`` threads and
    ``smem`` bytes of dynamic shared memory an H100 holds at once: CTAs an
    SM by threads (2048), CTAs (32), shared memory (228 KB, 1 KB reserved
    a CTA) and 128 registers a thread (the kernels' launch bounds), over
    the SMs, less an eighth for packing clusters into GPCs."""
    per_sm = min(2048 // threads, 32, (228 * 1024) // (smem + 1024),
                 65536 // (128 * threads))
    if ranks == 1:
        return sms * per_sm
    return sms * per_sm // ranks * 7 // 8


def sm_count(device) -> int:
    """The streaming multiprocessors of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def held_clusters(fn, args, plan, what: str) -> int:
    """How many clusters of ``plan`` the card holds at once, from a
    kernel's plan entry ``fn(*args, &smem, &held)``, which sizes the
    plan's shared memory as the launch does. Raises where the entry
    refuses the plan or its size differs from ``plan.smem``."""
    smem, held = ctypes.c_int(), ctypes.c_int()
    err = fn(*args, ctypes.byref(smem), ctypes.byref(held))
    if err != 0:
        raise RuntimeError(f"{what} plan {plan} refused by the kernels: "
                           f"CUDA error {err}")
    if smem.value != plan.smem:
        raise RuntimeError(f"{what} plan {plan}: the kernel needs "
                           f"{smem.value} bytes of shared memory")
    return held.value
