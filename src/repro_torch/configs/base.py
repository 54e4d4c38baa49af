"""Model configuration system + architecture registry of the port.

A copy of ``repro.configs.base`` (the port imports nothing of the JAX
package): the same ``LayerDesc`` and ``ModelConfig`` (every field, with
``dt_rank``, ``mamba_d_inner``, ``layer_list``, ``n_params_estimate``,
``n_active_params_estimate`` and ``reduced()``), and the dry-run's input
shapes ``ShapeSpec`` and ``SHAPES`` (``launch/specs.py``). The registry holds every card of the
reference: the dense GQA cards, Mixtral's MoE, DeepSeek-V2's MLA, Jamba's
Mamba, RWKV-6, the enc-dec SeamlessM4T-medium and the VLM stub Pixtral-12B.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Literal, Optional

__all__ = ["ModelConfig", "LayerDesc", "ShapeSpec", "SHAPES", "register", "get_config",
           "list_archs"]


@dataclasses.dataclass(frozen=True)
class LayerDesc:
    """One layer of a (possibly heterogeneous) block pattern."""

    mixer: Literal["gqa", "mla", "mamba", "rwkv6", "none"] = "gqa"
    ffn: Literal["dense", "moe", "none"] = "dense"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Literal["dense", "moe", "ssm", "hybrid", "encdec", "vlm", "audio"]
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128

    # layer pattern: (pattern, repeat) groups; default = uniform decoder
    pattern: tuple[LayerDesc, ...] = (LayerDesc(),)
    # if pattern repeats don't tile n_layers exactly, a prefix group is used
    prefix: tuple[LayerDesc, ...] = ()

    # attention options
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None
    attn_logit_softcap: Optional[float] = None

    # MLA (deepseek-style) options
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # MoE options
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    renorm_topk: bool = True
    capacity_factor: float = 1.25
    d_ff_dense: int = 0  # dense FFN width when pattern mixes dense+moe

    # Mamba options
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    mamba_dt_rank: int = 0  # 0 → ceil(d_model/16)

    # RWKV options
    rwkv_head_dim: int = 64
    rwkv_decay_lora: int = 64
    rwkv_gate_lora: int = 64

    # enc-dec options
    n_encoder_layers: int = 0
    encdec: bool = False

    # modality frontend stub
    frontend: Literal["none", "audio_frames", "vision_patches"] = "none"
    n_patches: int = 0  # vision: positions replaced by patch embeddings

    # FFN activation: swiglu (3 mats), relu2/gelu (2 mats), rwkv_cm (channel mix)
    ffn_act: Literal["swiglu", "relu2", "gelu", "rwkv_cm"] = "swiglu"

    # norms / embeddings
    norm_type: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    parallel_block: bool = False  # command-r style parallel attn+ffn

    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    # citation / provenance
    source: str = ""

    # ---- derived ---------------------------------------------------------------
    @property
    def dt_rank(self) -> int:
        return self.mamba_dt_rank or -(-self.d_model // 16)

    @property
    def mamba_d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    @property
    def layer_list(self) -> tuple[tuple[tuple[LayerDesc, ...], int], ...]:
        """((pattern, repeat), ...) groups covering n_layers."""
        groups = []
        remaining = self.n_layers
        if self.prefix:
            groups.append((self.prefix, 1))
            remaining -= len(self.prefix)
        plen = len(self.pattern)
        if remaining % plen:
            raise ValueError(f"{self.name}: {remaining} layers not tiled by pattern {plen}")
        groups.append((self.pattern, remaining // plen))
        return tuple(groups)

    @property
    def n_params_estimate(self) -> int:
        """Analytic parameter count (used for roofline 6ND and memory checks)."""
        d = self.d_model
        total = self.vocab * d  # embed
        if not self.tie_embeddings:
            total += self.vocab * d
        for pattern, repeat in self.layer_list:
            for desc in pattern:
                p = 0
                if desc.mixer == "gqa":
                    p += d * self.n_heads * self.head_dim  # q
                    p += 2 * d * self.n_kv_heads * self.head_dim  # k, v
                    p += self.n_heads * self.head_dim * d  # o
                elif desc.mixer == "mla":
                    qr = self.q_lora_rank or d
                    p += d * self.q_lora_rank if self.q_lora_rank else 0
                    p += qr * self.n_heads * (self.qk_nope_head_dim + self.qk_rope_head_dim)
                    p += d * (self.kv_lora_rank + self.qk_rope_head_dim)
                    p += self.kv_lora_rank * self.n_heads * (self.qk_nope_head_dim + self.v_head_dim)
                    p += self.n_heads * self.v_head_dim * d
                elif desc.mixer == "mamba":
                    di, ds, dr = self.mamba_d_inner, self.mamba_d_state, self.dt_rank
                    p += d * 2 * di + di * self.mamba_d_conv + di * (dr + 2 * ds) + dr * di
                    p += di * ds + 2 * di + di * d
                elif desc.mixer == "rwkv6":
                    p += 4 * d * d + d * d  # r,k,v,o + gate
                    p += self.rwkv_decay_lora * 2 * d + self.rwkv_gate_lora * 2 * d
                if desc.ffn == "dense":
                    ff = self.d_ff_dense or self.d_ff
                    if self.ffn_act == "swiglu":
                        p += 3 * d * ff
                    elif self.ffn_act == "rwkv_cm":
                        p += 2 * d * ff + d * d
                    else:  # relu2 / gelu
                        p += 2 * d * ff
                elif desc.ffn == "moe":
                    p += d * self.n_experts  # router
                    p += self.n_experts * 3 * d * self.d_ff_expert
                    p += self.n_shared_experts * 3 * d * self.d_ff_expert
                total += p * repeat
        if self.encdec:
            # encoder layers: self-attn + dense ffn; decoder adds cross-attn
            n_ffn_mats = 3 if self.ffn_act == "swiglu" else 2
            enc = self.n_encoder_layers * (
                d * self.n_heads * self.head_dim * 2
                + 2 * d * self.n_kv_heads * self.head_dim
                + n_ffn_mats * d * self.d_ff
            )
            cross = self.n_layers * (
                d * self.n_heads * self.head_dim * 2 + 2 * d * self.n_kv_heads * self.head_dim
            )
            total += enc + cross
        return total

    @property
    def n_active_params_estimate(self) -> int:
        """Active params per token (MoE: only top-k + shared experts)."""
        if self.n_experts == 0:
            return self.n_params_estimate
        total = self.n_params_estimate
        # subtract inactive routed experts in every MoE layer
        n_moe_layers = 0
        for pattern, repeat in self.layer_list:
            n_moe_layers += sum(1 for dsc in pattern if dsc.ffn == "moe") * repeat
        inactive = (self.n_experts - self.top_k) * 3 * self.d_model * self.d_ff_expert
        return total - n_moe_layers * inactive

    def reduced(self) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests."""
        plen = max(len(self.pattern), 1)
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=len(self.prefix) + plen,
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            head_dim=16,
            d_ff=128,
            d_ff_dense=128 if self.d_ff_dense else 0,
            vocab=512,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            d_ff_expert=64 if self.d_ff_expert else 0,
            n_shared_experts=min(self.n_shared_experts, 1),
            q_lora_rank=32 if self.q_lora_rank else 0,
            kv_lora_rank=32 if self.kv_lora_rank else 0,
            qk_nope_head_dim=16 if self.qk_nope_head_dim else 0,
            qk_rope_head_dim=8 if self.qk_rope_head_dim else 0,
            v_head_dim=16 if self.v_head_dim else 0,
            n_encoder_layers=min(self.n_encoder_layers, 2),
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else None,
            mamba_dt_rank=8 if self.family in ("hybrid", "ssm") else 0,
            rwkv_head_dim=16,
            rwkv_decay_lora=8,
            rwkv_gate_lora=8,
            n_patches=min(self.n_patches, 4) if self.n_patches else 0,
        )


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

_REGISTRY: dict[str, ModelConfig] = {}

# The cards, each under _unused/ as in the reference.
_ARCH_MODULES = [
    "_unused.seamless_m4t_medium",
    "_unused.qwen2_5_32b",
    "_unused.minitron_8b",
    "_unused.command_r_35b",
    "_unused.starcoder2_3b",
    "_unused.pixtral_12b",
    "_unused.mixtral_8x22b",
    "_unused.deepseek_v2_236b",
    "_unused.jamba_v0_1_52b",
    "_unused.rwkv6_3b",
]


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def _load_all():
    for mod in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        _load_all()
    if name in _REGISTRY:
        return _REGISTRY[name]
    raise KeyError(f"architecture {name!r} is unknown; known: {sorted(_REGISTRY)}")


def list_archs() -> list[str]:
    _load_all()
    return sorted(_REGISTRY)
