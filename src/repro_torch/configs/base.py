"""Model configuration system + architecture registry of the port.

A copy of ``repro.configs.base`` (the port imports nothing of the JAX
package): the same ``LayerDesc`` and ``ModelConfig`` (every field, with
``layer_list``, ``n_params_estimate`` and ``reduced()``). What only the
unported mixers read (their parameter counts, the Mamba derived widths) and
the benchmark shapes come with the slices that need them. The registry
holds only the cards whose layers the port has (the dense GQA cards and
Mixtral's MoE): :func:`get_config` of any other name says that it is not
yet ported.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Literal, Optional

__all__ = ["ModelConfig", "LayerDesc", "WAITING_SLICES", "register", "get_config", "list_archs"]


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
        """Analytic parameter count (used for roofline 6ND and memory checks).

        The reference's formula for the layers the port has (GQA mixer,
        dense and MoE FFN); the other mixers, the RWKV channel mix and
        enc-dec wait for their slices."""
        if self.encdec:
            raise NotImplementedError(
                f"{self.name}: enc-dec waits for its slice ({WAITING_SLICES['encdec']})")
        d = self.d_model
        total = self.vocab * d  # embed
        if not self.tie_embeddings:
            total += self.vocab * d
        for pattern, repeat in self.layer_list:
            for desc in pattern:
                if desc.mixer not in ("gqa", "none") or (
                        desc.ffn == "dense" and self.ffn_act == "rwkv_cm"):
                    raise NotImplementedError(
                        f"{self.name}: {desc} with ffn_act={self.ffn_act!r} waits for its "
                        f"slice ({WAITING_SLICES.get(desc.mixer, WAITING_SLICES['rwkv_cm'])})")
                p = 0
                if desc.mixer == "gqa":
                    p += d * self.n_heads * self.head_dim  # q
                    p += 2 * d * self.n_kv_heads * self.head_dim  # k, v
                    p += self.n_heads * self.head_dim * d  # o
                if desc.ffn == "dense":
                    ff = self.d_ff_dense or self.d_ff
                    p += (3 if self.ffn_act == "swiglu" else 2) * d * ff  # relu2 / gelu: 2
                elif desc.ffn == "moe":
                    p += d * self.n_experts  # router
                    p += self.n_experts * 3 * d * self.d_ff_expert
                    p += self.n_shared_experts * 3 * d * self.d_ff_expert
                total += p * repeat
        return total

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


#: the ROADMAP items that port what the port does not have yet: the
#: mixers, the RWKV channel mix, enc-dec with its cross-attention, the VLM
#: and audio frontends
WAITING_SLICES = {
    "mla": "ROADMAP A.6.2",
    "mamba": "ROADMAP A.6.4",
    "rwkv6": "ROADMAP A.6.4",
    "rwkv_cm": "ROADMAP A.6.4",
    "encdec": "ROADMAP A.6.5",
}

_REGISTRY: dict[str, ModelConfig] = {}

# The cards whose path the port runs; each lives under _unused/ as in the
# reference. The other cards of the reference wait for their mixers:
# DeepSeek-V2 for MLA (ROADMAP A.6.2), Jamba and RWKV6 for Mamba and RWKV
# (A.6.4), Seamless and Pixtral for enc-dec and the VLM stub (A.6.5).
_ARCH_MODULES = [
    "_unused.qwen2_5_32b",
    "_unused.minitron_8b",
    "_unused.command_r_35b",
    "_unused.starcoder2_3b",
    "_unused.mixtral_8x22b",
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
    raise KeyError(
        f"architecture {name!r} is unknown or not yet ported (ROADMAP A.6); "
        f"ported: {sorted(_REGISTRY)}"
    )


def list_archs() -> list[str]:
    _load_all()
    return sorted(_REGISTRY)
