"""DistributedStrategy (counterpart of
``paddle_tpu/distributed/strategy.py``; parity:
paddle.distributed.fleet.DistributedStrategy).

A serializable dataclass holding every distributed knob, field for field
the JAX one, so ``serialize``/``deserialize`` round trip JSON between the
two packages. The hybrid mesh's axis order is Fleet's
``HybridCommunicateGroup`` convention (``topology.AXIS_ORDER``: dp, pp,
fsdp, ep, sep, tp): rank r's coordinates are device r's in the JAX mesh.
``TrainStep`` reads the degrees, the sharding stage and gradient merge;
it runs dp, fsdp (ZeRO stages 1-3) and tp, and refuses pp, sep, cp and
ep above 1 (ROADMAP.md Queue A7, second half).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional


@dataclasses.dataclass
class HybridConfig:
    dp_degree: int = 1
    mp_degree: int = 1  # tensor parallel
    pp_degree: int = 1  # pipeline parallel
    sharding_degree: int = 1  # ZeRO/FSDP axis
    sep_degree: int = 1  # Ulysses-style sequence/segment parallel
    ep_degree: int = 1  # expert parallel (MoE), its own "ep" mesh axis
    cp_degree: int = 1  # ring-attention context parallel

    def total(self) -> int:
        return (self.dp_degree * self.mp_degree * self.pp_degree
                * self.sharding_degree * self.ep_degree * self.sep_degree
                * self.cp_degree)


@dataclasses.dataclass
class ShardingConfig:
    """Parity: DistributedStrategy.sharding_configs."""

    stage: int = 1  # 1: opt states, 2: +grads, 3: +params
    degree: int = 8
    offload: bool = False
    comm_overlap: bool = True


@dataclasses.dataclass
class RecomputeConfig:
    enable: bool = False
    # the JAX checkpoint policy name (models/llama.py maps it to a
    # selective torch.utils.checkpoint policy)
    policy: str = "dots_with_no_batch_dims_saveable"
    checkpoint_layers: Optional[list] = None


@dataclasses.dataclass
class AmpConfig:
    enable: bool = False
    dtype: str = "bfloat16"
    level: str = "O2"
    init_loss_scaling: float = 32768.0
    use_dynamic_loss_scaling: bool = False  # bf16: off


@dataclasses.dataclass
class PipelineConfig:
    micro_batch_size: int = 1
    accumulate_steps: int = 1
    schedule_mode: str = "1F1B"  # or "F-then-B", "VPP"
    vpp_degree: int = 1


@dataclasses.dataclass
class MoEConfig:
    num_experts: int = 1
    top_k: int = 2
    capacity_factor: float = 1.25
    gate: str = "gshard"  # gshard | switch | naive
    aux_loss_weight: float = 0.01


_SUBCONFIGS = {c.__name__: c for c in (
    HybridConfig, ShardingConfig, RecomputeConfig, AmpConfig,
    PipelineConfig, MoEConfig)}


@dataclasses.dataclass
class DistributedStrategy:
    hybrid_configs: HybridConfig = dataclasses.field(
        default_factory=HybridConfig)
    sharding_configs: ShardingConfig = dataclasses.field(
        default_factory=ShardingConfig)
    recompute_configs: RecomputeConfig = dataclasses.field(
        default_factory=RecomputeConfig)
    amp_configs: AmpConfig = dataclasses.field(default_factory=AmpConfig)
    pipeline_configs: PipelineConfig = dataclasses.field(
        default_factory=PipelineConfig)
    moe_configs: MoEConfig = dataclasses.field(default_factory=MoEConfig)
    sharding: bool = False
    recompute: bool = False
    amp: bool = False
    pipeline: bool = False
    gradient_merge: bool = False
    gradient_merge_k_steps: int = 1
    find_unused_parameters: bool = False
    fuse_grad_size_in_MB: int = 32  # kept for the API; not read

    # ------------------------------------------------------------------
    def serialize(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def deserialize(cls, text: str) -> "DistributedStrategy":
        """The strategy of ``serialize``'s JSON (the JAX package's too);
        unknown keys are skipped."""
        def build(klass, d):
            fields = {f.name: f for f in dataclasses.fields(klass)}
            kwargs = {}
            for k, val in d.items():
                if k not in fields:
                    continue
                ft = fields[k].type
                sub = _SUBCONFIGS.get(
                    ft if isinstance(ft, str) else getattr(ft, "__name__",
                                                           ""))
                kwargs[k] = (build(sub, val) if sub and isinstance(val, dict)
                             else val)
            return klass(**kwargs)

        return build(cls, json.loads(text))

    # the degrees the sharding engine reads
    @property
    def tp(self) -> int:
        return self.hybrid_configs.mp_degree

    @property
    def dp(self) -> int:
        return self.hybrid_configs.dp_degree

    @property
    def pp(self) -> int:
        return self.hybrid_configs.pp_degree

    @property
    def fsdp(self) -> int:
        return self.hybrid_configs.sharding_degree

    @property
    def sep(self) -> int:
        return self.hybrid_configs.sep_degree

    @property
    def sharding_stage(self) -> int:
        return self.sharding_configs.stage if (
            self.sharding or self.hybrid_configs.sharding_degree > 1
        ) else 0
