"""Single typed configuration for training/inference apps.

A copy of ``flowtrain_stochastic_interpolation_tpu/config.py``: the port keeps
its own so that nothing here imports the JAX package.

Replaces the reference's duplicated ``get_config()`` dict literals
(``model_train_inference.py:40-127``, ``model_train_sh_inference_cond.py:49-160``,
``model_inference_experiments.py:22-129`` — flagged in SURVEY.md §5 as a sharp
edge: configs had to match the checkpoint by hand).  One dataclass tree,
serialised into every checkpoint, reconstructs the experiment exactly.

Presets :func:`unconditional_64` and :func:`conditional_64` carry the
reference's published hyperparameters verbatim.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple


@dataclass(frozen=True)
class ModelConfig:
    """UNet hyperparameters (reference ``config["model"]``)."""

    dim: int = 48
    dim_mults: Tuple[int, ...] = (1, 1, 2, 3, 4)
    data_channels: int = 18  # set to embedding dim by the apps
    dropout: float = 0.1
    self_condition: bool = False
    time_sin_pos: bool = False
    time_resolution: int = 1024
    time_bandwidth: float = 1000.0
    time_learned_emb: bool = True
    attn_enabled: bool = True
    attn_dim_head: int = 32
    attn_heads: int = 4
    full_attn: Optional[Tuple[bool, ...]] = None
    flash_attn: bool = True
    fused_folded_attn: bool = True  # head-folded Pallas linear attention
    conditional: bool = False
    cond_variant: str = "v3"
    dtype: str = "bfloat16"  # compute dtype; params stay f32
    # folded-linear-attention backward:
    # "closed_form" | "closed_form_bf16" | "chunked" | "autodiff" | None
    # (None = closed_form_bf16 — the r5 default after the paired flagship
    # A/B (BASELINE.md); identical math when streams are f32, ~0.7% faster
    # when bf16 — unless FLOWTRAIN_AUTODIFF_ATTN_VJP was set at import, a
    # trace-time constant, see ops/linear_attention.py)
    attn_folded_vjp: str | None = None
    # per-block rematerialisation inside the UNet (jax.checkpoint around each
    # ResnetBlock/attention): bounds backward activation liveness to one
    # block — the form that fits 128³ b1 training on one chip (a single
    # whole-forward checkpoint cannot: its transpose keeps the entire
    # recomputed forward live)
    remat_blocks: bool = False


@dataclass(frozen=True)
class DataConfig:
    """Data source (reference ``config["data"]`` + embedding block)."""

    shape: Tuple[int, int, int] = (64, 64, 64)
    bounds: Tuple[Tuple[float, float], ...] = ((-1920, 1920), (-1920, 1920), (-1920, 1920))
    batch_size: int = 6
    epoch_size: int = 10_000
    num_categories: int = 15
    embedding_dim: int = 18
    source: str = "synthetic"  # "synthetic" | "geogen"


@dataclass(frozen=True)
class EMAConfig:
    """EMA shadow (reference cond ``callbacks.py:219-317``)."""

    enabled: bool = True
    decay: float = 0.9995
    start_step: int = 0
    update_every: int = 1


@dataclass(frozen=True)
class TrainingConfig:
    """Optimisation (reference ``config["training"]``)."""

    max_epochs: int = 2000
    learning_rate: float = 2.0e-4
    lr_decay: float = 0.997  # per epoch, staircase (ExponentialLR semantics)
    gradient_clip_val: float = 1.0
    accumulate_grad_batches: int = 24
    optimizer: str = "adam"  # "adam" | "adamw"
    weight_decay: float = 0.01  # only for adamw (torch default)
    time_range: Tuple[float, float] = (0.0005, 0.9995)
    x1_noise: float = 1e-3
    lambda_reconstruct: float = 1.0  # conditional only
    remat: bool = False  # rematerialise the forward in backward (fit larger batches)
    # what the checkpointed forward may keep for the backward:
    #   "dots"    — contraction results without batch dims (cheap recompute,
    #               but at 128³ the saved qkv projections alone are 1.5 GB/stage)
    #   "nothing" — full recompute; the minimum-HBM form that fits 128³ b1
    #               training on one 16 GB chip
    remat_policy: str = "dots"
    # storage dtype of the objective pipeline's volume tensors (X0/X1/XT/VT):
    # "bfloat16" halves every [B,X,Y,Z,E] buffer (loss still reduces in f32,
    # T stays f32) — with remat_policy="nothing" this is what fits 128³ b1
    # training on one 16 GB chip
    objective_dtype: str = "float32"
    # under remat, save the conditioning-tower (EmbedATb) tensors instead of
    # recomputing them — their k=5 conv recompute carries a 2.7×-padded XLA
    # lowering temp that dominated the cond-b4 OOM dump (docs/roofline.md)
    remat_save_atb: bool = True
    log_every_n_steps: int = 5
    seed: int = 0
    checkpoint_every_steps: int = 1000
    keep_checkpoints: int = 3
    inference_every_epochs: int = 5


@dataclass(frozen=True)
class InferenceConfig:
    """Sampling (reference ``run_inference`` settings)."""

    t0: float = 0.001
    tf: float = 1.0
    n_frames: int = 16
    substeps: int = 2
    method: str = "rk4"
    adaptive: bool = False
    atol: float = 1e-6
    rtol: float = 1e-6
    n_samples: int = 8
    batch_size: int = 4
    seed: int = 100


@dataclass(frozen=True)
class ExperimentConfig:
    name: str = "cat-embeddings-18d-normed-64cubed"
    root_dir: str = "."
    resume: bool = True
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    ema: EMAConfig = field(default_factory=EMAConfig)
    inference: InferenceConfig = field(default_factory=InferenceConfig)

    # ---- serialisation -------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ExperimentConfig":
        def _mk(klass, dd):
            fields = {f.name: f for f in dataclasses.fields(klass)}
            kwargs = {}
            for k, v in dd.items():
                if k not in fields:
                    continue
                if dataclasses.is_dataclass(fields[k].type) or k in (
                    "model", "data", "training", "ema", "inference"
                ):
                    sub = {
                        "model": ModelConfig, "data": DataConfig,
                        "training": TrainingConfig, "ema": EMAConfig,
                        "inference": InferenceConfig,
                    }[k]
                    kwargs[k] = _mk(sub, v)
                elif isinstance(v, list):
                    kwargs[k] = tuple(tuple(i) if isinstance(i, list) else i for i in v)
                else:
                    kwargs[k] = v
            return klass(**kwargs)

        return _mk(cls, d)

    @classmethod
    def from_json(cls, s: str) -> "ExperimentConfig":
        return cls.from_dict(json.loads(s))


def unconditional_64(**overrides) -> ExperimentConfig:
    """Reference unconditional recipe (``model_train_inference.py:51-115``)."""
    cfg = ExperimentConfig(
        name="cat-embeddings-18d-normed-64cubed",
        model=ModelConfig(
            dim=48, dim_mults=(1, 1, 2, 3, 4), data_channels=18, dropout=0.1,
            time_resolution=1024, time_bandwidth=1000.0, time_learned_emb=True,
            attn_dim_head=32, attn_heads=4, conditional=False,
        ),
        data=DataConfig(batch_size=6, epoch_size=10_000, embedding_dim=18),
        training=TrainingConfig(
            learning_rate=2.0e-4, lr_decay=0.997, gradient_clip_val=1.0,
            accumulate_grad_batches=24, optimizer="adam",
            time_range=(0.0005, 0.9995), x1_noise=1e-3,
        ),
        ema=EMAConfig(enabled=False),  # uncond run used the legacy no-op EMA
        inference=InferenceConfig(t0=0.001, tf=1.0, n_frames=16),
    )
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def tiny_test(conditional: bool = False, **overrides) -> ExperimentConfig:
    """8³ smoke preset for CI / CPU end-to-end runs of the apps."""
    cfg = ExperimentConfig(
        name="tiny-smoke-cond" if conditional else "tiny-smoke",
        model=ModelConfig(
            dim=8, dim_mults=(1, 2), data_channels=15, dropout=0.0,
            time_resolution=16, time_bandwidth=10.0, time_learned_emb=True,
            attn_dim_head=4, attn_heads=2, conditional=conditional,
            dtype="float32",
        ),
        data=DataConfig(shape=(8, 8, 8), batch_size=4, epoch_size=32, embedding_dim=15),
        training=TrainingConfig(
            learning_rate=2e-3, accumulate_grad_batches=1, log_every_n_steps=1,
            time_range=(0.001, 0.999), checkpoint_every_steps=50,
        ),
        ema=EMAConfig(enabled=True, decay=0.99),
        inference=InferenceConfig(n_frames=4, substeps=1, method="euler",
                                  n_samples=2, batch_size=2),
    )
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def conditional_64(**overrides) -> ExperimentConfig:
    """Reference conditional recipe (``model_train_sh_inference_cond.py:59-128``)."""
    cfg = ExperimentConfig(
        name="cond-3d-64cubed",
        model=ModelConfig(
            dim=48, dim_mults=(1, 2, 2, 3, 4), data_channels=15, dropout=0.1,
            time_resolution=1024, time_bandwidth=1000.0, time_learned_emb=True,
            attn_dim_head=32, attn_heads=4, conditional=True, cond_variant="v3",
        ),
        data=DataConfig(batch_size=8, epoch_size=20_000, embedding_dim=15),
        training=TrainingConfig(
            learning_rate=1.0e-3, lr_decay=0.999, gradient_clip_val=0.3,
            accumulate_grad_batches=4, optimizer="adamw",
            time_range=(0.0001, 0.9999), x1_noise=1e-4, lambda_reconstruct=1.0,
        ),
        ema=EMAConfig(enabled=True, decay=0.9995, start_step=0, update_every=1),
        inference=InferenceConfig(t0=0.0001, tf=0.9999, n_frames=8),
    )
    return dataclasses.replace(cfg, **overrides) if overrides else cfg
