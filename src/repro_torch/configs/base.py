"""Config dataclasses for models, shapes, meshes and training.
Reference: ``src/repro/configs/base.py``.

Field names, defaults and derived properties are the reference's, so a
config converts across by ``dataclasses.asdict``. Which fields the port
honours is decided where they are read: ``ExecutionConfig`` and
``TrainConfig`` options of later slices are refused by the trainer
(``repro_torch.train.loop``) with a message naming their queue item.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts FFN configuration (shared + routed experts)."""

    num_experts: int = 0              # routed experts
    num_shared_experts: int = 0       # always-on experts
    top_k: int = 2
    expert_d_ff: int = 0              # d_ff of each routed expert
    shared_d_ff: int = 0              # total d_ff of the shared expert block
    router_aux_weight: float = 0.001  # load-balance aux loss weight
    first_dense: int = 0              # leading dense (non-MoE) layers
    dense_d_ff: int = 0               # d_ff of those leading dense layers
    capacity_factor: float = 1.25
    partition_mode: str = "tp"

    @property
    def enabled(self) -> bool:
        return self.num_experts > 0


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 multi-head latent attention."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 0              # 0 => full-rank q projection
    qk_rope_dim: int = 64             # per-head rope sub-dimension
    qk_nope_dim: int = 128            # per-head non-rope sub-dimension
    v_head_dim: int = 128

    @property
    def enabled(self) -> bool:
        return self.kv_lora_rank > 0


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba/SSD-style state-space head config (used by hymba, rwkv6)."""

    state_dim: int = 16
    conv_dim: int = 4                 # depthwise conv width (mamba)
    expand: int = 2                   # inner dim multiplier
    num_heads: int = 0                # SSD heads (0 => derive)

    @property
    def enabled(self) -> bool:
        return self.state_dim > 0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """A single unified model description (the reference's field set)."""

    name: str = "model"
    family: str = "dense"             # dense | moe | vlm | hybrid | ssm | audio
    num_layers: int = 2
    d_model: int = 128
    num_heads: int = 2
    num_kv_heads: int = 2
    head_dim: int = 0                 # 0 => d_model // num_heads
    d_ff: int = 512
    vocab_size: int = 1024
    max_seq_len: int = 8192

    # attention details
    attention_kind: str = "gqa"       # gqa | mla | none (attn-free)
    mla: MLAConfig = MLAConfig(kv_lora_rank=0)
    qk_norm: bool = False
    rope_theta: float = 10000.0
    # sliding_window=0 => all layers global. global_every=k => layer i is
    # global iff (i+1) % k == 0 (gemma3's 5 local : 1 global).
    sliding_window: int = 0
    global_every: int = 0
    attn_logit_softcap: float = 0.0

    # ffn
    hidden_act: str = "swiglu"        # swiglu | gelu | relu_sq
    moe: MoEConfig = MoEConfig()

    # alternative token mixers
    ssm: SSMConfig = SSMConfig()
    hybrid_parallel: bool = False
    rwkv_head_dim: int = 64

    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    encoder_seq_len: int = 1500

    num_prefix_embeds: int = 0

    use_bias: bool = False
    tie_embeddings: bool = False
    embed_scale: float = 1.0          # gemma multiplies embeds by sqrt(d)
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"           # activation/param dtype
    vocab_pad_multiple: int = 128

    # remat policy of the reference's scanned blocks (training only)
    remat: str = "full"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)


# ---------------------------------------------------------------------------
# Input shapes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                         # train | prefill | decode

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4_096, 256, "train"),
    ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    ShapeConfig("decode_32k", 32_768, 128, "decode"),
    ShapeConfig("long_500k", 524_288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}


# ---------------------------------------------------------------------------
# Mesh / distribution configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Logical mesh description. axes are named; 'pod' optional."""

    shape: Tuple[int, ...] = (16, 16)
    axes: Tuple[str, ...] = ("data", "model")

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


SINGLE_POD_MESH = MeshConfig((16, 16), ("data", "model"))


# ---------------------------------------------------------------------------
# Aggregation / training configuration (the paper's knobs)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AggregationConfig:
    """The paper's Sync/Async/backup-worker policy knobs. The port builds
    the mask strategies 'full_sync', 'backup' and 'timeout' and the event
    strategies 'async', 'softsync' (``softsync_c``) and 'staleness'
    (``staleness_tau`` / ``_ramp_steps`` / ``_jitter``), and
    'dynamic_backup' (``dynamic_window``, ``dynamic_min_workers``,
    ``latency_source``) (``repro_torch.core.registry.get_strategy``)."""

    strategy: str = "backup"
    num_workers: int = 16             # N
    backup_workers: int = 0           # b  (total launched = N + b)
    deadline_s: float = 0.0           # timeout strategy
    softsync_c: int = 1
    dynamic_window: int = 32
    dynamic_min_workers: int = 0
    latency_source: str = "sim"
    staleness_tau: int = 0
    staleness_ramp_steps: int = 0
    staleness_jitter: int = 0
    compression: str = "none"
    zero1: bool = False

    @property
    def total_workers(self) -> int:
        return self.num_workers + self.backup_workers


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "rmsprop_momentum"    # paper's optimizer for Inception
    learning_rate: float = 0.045
    # paper's rule-of-thumb: lr scales linearly with N (A.3: 0.045*N)
    scale_lr_with_workers: bool = True
    decay: float = 0.9                # rmsprop decay
    momentum: float = 0.9
    eps: float = 1e-8
    beta1: float = 0.9                # adam
    beta2: float = 0.999
    weight_decay: float = 0.0
    # exponential schedule gamma0 * beta^(t*N/(2T)) (paper A.2/A.3)
    lr_decay_rate: float = 0.94
    steps_per_epoch: int = 0          # T = |X|/B; 0 disables the schedule
    # linear anneal to 0 over [linear_anneal_from, linear_anneal_steps]
    linear_anneal_steps: int = 0
    linear_anneal_from: int = 0
    warmup_steps: int = 0
    clip_global_norm: float = 0.0     # >0 enables
    ema_decay: float = 0.9999         # paper evaluates on EMA of params


@dataclasses.dataclass(frozen=True)
class ExecutionConfig:
    """How the W coordination workers are executed.

    'sim'  — the mask-weighted loss over one global batch.
    'spmd' — the engine (``repro_torch.distributed.spmd_engine``): each
             worker's own gradient, written into one ``[W_local, P]`` f32
             stack per rank, then the masked reduce and, over the
             ``mesh_data`` positions of the ``'data'`` axis
             (``distributed.mesh``), one all-reduce per bucket. With
             ``mesh_model`` > 1 each worker's gradient is tensor-parallel
             over a ``'model'`` group of that many ranks, each holding its
             slice of the parameters, optimizer state and EMA
             (``distributed.sharding``, ``distributed.tp``): the world is
             ``mesh_data * mesh_model`` ranks.

    ``use_kernel``: None = the ``backup_reduce`` CUDA kernel on the card
    and its plain twin on the CPU; True = the kernel (raises on the CPU);
    False = the plain twin. ``interpret`` is Pallas-only: None or False.
    """

    backend: str = "sim"              # 'sim' | 'spmd'
    mesh_data: int = 1                # 'data' axis size (devices); W % it == 0
    mesh_model: int = 1               # 'model' (tensor-parallel) axis size
    use_kernel: Optional[bool] = None
    interpret: Optional[bool] = None
    # per-worker gradient batching: 0 = all local workers in one
    # torch.func.vmap, 1 = one worker at a time, k = groups of k workers
    grad_batch: int = 0
    # lanes of the flattened gradient per bucket (0 = one bucket)
    bucket_size: int = 0

    @property
    def num_devices(self) -> int:
        return self.mesh_data * self.mesh_model


@dataclasses.dataclass(frozen=True)
class CheckpointConfig:
    directory: str = "checkpoints"
    every_steps: int = 100
    keep: int = 3
    async_save: bool = False
    write_retries: int = 3
    retry_backoff_s: float = 0.01
    retry_max_backoff_s: float = 0.25
    retry_jitter: float = 0.5


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Seeded fault injection + recovery supervision: ``spec`` is a chaos
    plan for ``core.faults.plan_from_spec``, ``seed`` its own seed,
    ``supervise`` routes the CLI's run through
    ``train.supervisor.run_supervised`` within ``max_restarts``."""

    spec: str = ""
    seed: int = 0
    supervise: bool = False
    max_restarts: int = 3


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    model: ModelConfig = ModelConfig()
    shape: ShapeConfig = SHAPES_BY_NAME["train_4k"]
    mesh: MeshConfig = SINGLE_POD_MESH
    aggregation: AggregationConfig = AggregationConfig()
    optimizer: OptimizerConfig = OptimizerConfig()
    checkpoint: CheckpointConfig = CheckpointConfig()
    execution: ExecutionConfig = ExecutionConfig()
    faults: FaultConfig = FaultConfig()
    seed: int = 0
    total_steps: int = 1000
    log_every: int = 10
    microbatch: int = 0               # 0 => derive from shape & mesh
    # iterations per device dispatch: the port runs 1 (the per-step path)
    chunk_size: int = 1
    # 'host' (numpy straggler streams, bit-equal to the reference) or
    # 'device' (arrivals, batches and masks drawn on the device per chunk)
    straggler_backend: str = "host"
    prefetch_depth: int = 1


def replace(cfg, **kw):
    """dataclasses.replace passthrough (ergonomic alias)."""
    return dataclasses.replace(cfg, **kw)
