"""DistributedStrategy (counterpart of
``paddle_tpu/distributed/strategy.py``; parity:
paddle.distributed.fleet.DistributedStrategy).

The port's own copy of the part of the JAX dataclasses that the one-card
train step reads: the hybrid degrees and gradient merge. A strategy that
asks for more than one device is refused by ``check_one_device``: the
port trains on one card at this slice (ROADMAP.md Queue A,
distributed).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class HybridConfig:
    dp_degree: int = 1
    mp_degree: int = 1  # tensor parallel
    pp_degree: int = 1  # pipeline parallel
    sharding_degree: int = 1  # ZeRO/FSDP axis
    sep_degree: int = 1  # Ulysses-style sequence parallel
    ep_degree: int = 1  # expert parallel (MoE)
    cp_degree: int = 1  # ring-attention context parallel

    def total(self) -> int:
        return (self.dp_degree * self.mp_degree * self.pp_degree
                * self.sharding_degree * self.ep_degree * self.sep_degree
                * self.cp_degree)


@dataclasses.dataclass
class DistributedStrategy:
    hybrid_configs: HybridConfig = dataclasses.field(
        default_factory=HybridConfig)
    gradient_merge: bool = False
    gradient_merge_k_steps: int = 1

    def check_one_device(self):
        """Raise ``NotImplementedError`` unless every degree is 1."""
        total = self.hybrid_configs.total()
        if total != 1:
            raise NotImplementedError(
                f"the strategy asks for {total} devices "
                f"({self.hybrid_configs}); the port trains on one card at "
                "this slice (see ROADMAP.md Queue A, distributed)")
