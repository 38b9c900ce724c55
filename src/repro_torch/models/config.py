"""Model configuration dataclasses for every assigned architecture family."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int
    n_shared: int = 0
    router_aux_coef: float = 0.01
    # first N layers stay dense (DeepSeek-V2 keeps layer 0 dense)
    n_dense_layers: int = 0
    dense_d_ff: int | None = None
    capacity_factor: float = 1.25
    # exact dispatch (capacity = n_tokens, no drops) — used by reduced
    # smoke configs so decode == full forward bit-for-bit
    exact: bool = False


@dataclass(frozen=True)
class MLAConfig:
    kv_lora: int
    q_lora: int | None
    qk_nope_dim: int
    qk_rope_dim: int
    v_head_dim: int


@dataclass(frozen=True)
class SSMConfig:
    d_state: int
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class HybridConfig:
    """RecurrentGemma-style: blocks of (recurrent x R, local-attn x A)."""

    pattern: tuple[str, ...] = ("rec", "rec", "attn")
    window: int = 2048
    lru_width: int | None = None
    conv_width: int = 4


@dataclass(frozen=True)
class EncDecConfig:
    n_enc_layers: int
    n_frames: int            # stub frontend output length (e.g. 1500)
    frame_dim: int | None = None  # defaults to d_model


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str              # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None
    qkv_bias: bool = False
    rope_theta: float = 1_000_000.0
    mrope: bool = False      # qwen2-vl M-RoPE (3-section positions)
    mlp: str = "swiglu"      # swiglu | gelu | geglu
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    source: str = ""         # citation
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None
    hybrid: HybridConfig | None = None
    encdec: EncDecConfig | None = None
    # which input modality input_specs() provides
    input_kind: str = "tokens"   # tokens | embeds (vlm) | audio (enc-dec)
    # sub-quadratic decode? (controls long_500k eligibility)
    subquadratic: bool = False

    @property
    def hd(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // self.n_heads

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: <=2 layers (x pattern), d_model<=256,
        <=4 experts — same family and code paths."""
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4)
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        kw: dict = dict(
            n_layers=2, d_model=d_model, n_heads=n_heads, n_kv_heads=n_kv,
            d_ff=min(self.d_ff, 512) or 0, vocab=min(self.vocab, 512),
            head_dim=d_model // n_heads if self.head_dim else None,
        )
        if self.moe:
            kw["moe"] = replace(
                self.moe, n_experts=min(4, self.moe.n_experts),
                top_k=min(2, self.moe.top_k),
                d_expert=min(128, self.moe.d_expert),
                n_shared=min(1, self.moe.n_shared),
                n_dense_layers=min(1, self.moe.n_dense_layers),
                dense_d_ff=min(256, self.moe.dense_d_ff or 256)
                if self.moe.dense_d_ff else None,
                exact=True)
        if self.mla:
            kw["mla"] = replace(
                self.mla, kv_lora=min(64, self.mla.kv_lora),
                q_lora=min(96, self.mla.q_lora) if self.mla.q_lora else None,
                qk_nope_dim=32, qk_rope_dim=16, v_head_dim=32)
        if self.ssm:
            kw["ssm"] = replace(self.ssm, d_state=min(32, self.ssm.d_state),
                                head_dim=32, chunk=32)
        if self.hybrid:
            kw["hybrid"] = replace(self.hybrid, window=64,
                                   lru_width=d_model)
            kw["n_layers"] = len(self.hybrid.pattern)  # one full pattern
        if self.encdec:
            kw["encdec"] = replace(self.encdec, n_enc_layers=2, n_frames=8)
        return replace(self, **kw)

    # -- parameter counting (roofline MODEL_FLOPS = 6 N D) -----------------
    def param_count(self, active_only: bool = False) -> int:
        """Approximate parameter count; ``active_only`` counts only
        routed-active experts (MoE 6*N_active*D convention)."""
        d, L = self.d_model, self.n_layers
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        # attention
        if self.family == "ssm":
            s = self.ssm
            din = s.d_inner(d)
            nh = s.n_heads(d)
            per_layer += d * (2 * din + 2 * s.d_state * 0) \
                + d * (2 * din) + din * d  # in_proj(x,z) + out_proj
            per_layer += din * (2 * s.d_state) + nh * 2  # B,C proj + A,dt
            per_layer += s.d_conv * (din + 2 * s.d_state * nh // nh)
        elif self.mla:
            m = self.mla
            qdim = self.n_heads * (m.qk_nope_dim + m.qk_rope_dim)
            if m.q_lora:
                per_layer += d * m.q_lora + m.q_lora * qdim
            else:
                per_layer += d * qdim
            per_layer += d * (m.kv_lora + m.qk_rope_dim)
            per_layer += m.kv_lora * self.n_heads * (m.qk_nope_dim + m.v_head_dim)
            per_layer += self.n_heads * m.v_head_dim * d
        else:
            hd = self.hd
            per_layer += d * self.n_heads * hd          # q
            per_layer += 2 * d * self.n_kv_heads * hd   # k, v
            per_layer += self.n_heads * hd * d          # o
        # mlp
        def mlp_params(ff):
            return d * ff * (3 if self.mlp in ("swiglu", "geglu") else 2)
        if self.moe:
            n_e = self.moe.top_k if active_only else self.moe.n_experts
            moe_l = (mlp_params(self.moe.d_expert) * (n_e + self.moe.n_shared)
                     + d * self.moe.n_experts)
            dense_l = mlp_params(self.moe.dense_d_ff or self.d_ff)
            nd = self.moe.n_dense_layers
            total_mlp = nd * dense_l + (L - nd) * moe_l
        elif self.family == "ssm":
            total_mlp = 0
        else:
            total_mlp = L * mlp_params(self.d_ff)
        total = emb + L * per_layer + total_mlp
        if self.encdec:
            # encoder layers + cross-attention in decoder
            total += self.encdec.n_enc_layers * (per_layer + mlp_params(self.d_ff))
            total += L * 2 * d * self.n_heads * self.hd  # cross kv+o approx
        return int(total)
