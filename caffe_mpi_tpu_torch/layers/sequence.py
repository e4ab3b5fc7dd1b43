"""Sequence layers: LayerNorm, Attention, MoE.

JAX package: caffe_mpi_tpu/layers/sequence.py. Blob layout (N, S, C).
Attention declares a fused QKV weight (3C, C) and an output projection
(C, C) in Caffe's (num_output, K) convention, with biases under
`bias_term`; MoE declares the gate (C, E) and expert banks w1 (E, C, H),
b1 (E, H), w2 (E, H, C), b2 (E, C), and an optional scalar aux-loss top.
The products run under the layer's `DtypePolicy` math mode; with
`attention_param { use_flash: true }` the attention itself goes through
the flash kernels (ops/flash_attention.py).

`sequence_parallel: true` shards the sequence over a mesh in the JAX
package; with no mesh it runs standard attention there, and the port,
which has no mesh yet, does the same.
"""

from __future__ import annotations

import torch

from ..ops.attention import attention
from ..ops.moe import moe_ffn
from ..proto.config import (AttentionParameter, FillerParameter,
                            LayerNormParameter)
from .base import Layer, Shape, register


@register("LayerNorm")
class LayerNormLayer(Layer):
    """Normalization over the trailing (channel) axis in f32, with a
    learnable scale and bias under `scale_bias`. Stateless: the same in
    TRAIN and TEST."""

    def setup(self, in_shapes: list[Shape]) -> list[Shape]:
        p = self.lp.layer_norm_param or LayerNormParameter()
        self.p = p
        c = in_shapes[0][-1]
        if p.scale_bias:
            self.declare("scale", (c,),
                         FillerParameter(type="constant", value=1.0))
            self.declare("bias", (c,), FillerParameter(type="constant"))
        return [in_shapes[0]]

    def forward(self, bottoms):
        x = self.f(bottoms[0])
        x32 = x.float()
        mean = x32.mean(-1, keepdim=True)
        var = torch.square(x32 - mean).mean(-1, keepdim=True)
        y = ((x32 - mean) * torch.rsqrt(var + self.p.eps)).to(x.dtype)
        if self.p.scale_bias:
            y = y * self.f(self.scale) + self.f(self.bias)
        return [y]


@register("Attention")
class AttentionLayer(Layer):
    def setup(self, in_shapes: list[Shape]) -> list[Shape]:
        p = self.lp.attention_param or AttentionParameter()
        self.p = p
        if len(in_shapes[0]) != 3:
            raise ValueError(
                f"Attention expects (N, S, C) bottom, got {in_shapes[0]}")
        c = in_shapes[0][2]
        if c % max(p.num_heads, 1):
            raise ValueError(f"channels {c} not divisible by "
                             f"num_heads {p.num_heads}")
        self.heads = max(p.num_heads, 1)
        filler = p.weight_filler or FillerParameter(type="xavier")
        self.declare("qkv_weight", (3 * c, c), filler)
        self.declare("proj_weight", (c, c), filler)
        if p.bias_term:
            bias = p.bias_filler or FillerParameter(type="constant")
            self.declare("qkv_bias", (3 * c,), bias)
            self.declare("proj_bias", (c,), bias)
        return [in_shapes[0]]

    def forward(self, bottoms):
        p = self.p
        x = self.f(bottoms[0])
        n, s, c = x.shape
        with self.policy.math(x.device):
            qkv = x @ self.f(self.qkv_weight).t()
            if p.bias_term:
                qkv = qkv + self.f(self.qkv_bias)
            shape = (n, s, self.heads, c // self.heads)
            q, k, v = (t.reshape(shape) for t in qkv.split(c, dim=-1))
            out = attention(q, k, v, causal=bool(p.causal),
                            use_flash=bool(p.use_flash))
            y = out.reshape(n, s, c) @ self.f(self.proj_weight).t()
        if p.bias_term:
            y = y + self.f(self.proj_bias)
        return [y]


@register("MoE")
class MoELayer(Layer):
    def setup(self, in_shapes: list[Shape]) -> list[Shape]:
        p = self.lp.moe_param
        if p is None or p.num_experts < 1 or p.hidden_dim < 1:
            raise ValueError("moe_param needs num_experts and hidden_dim")
        self.p = p
        c = in_shapes[0][-1]
        filler = p.weight_filler or FillerParameter(type="xavier")
        self.declare("gate", (c, p.num_experts),
                     FillerParameter(type="gaussian", std=0.02))
        self.declare("w1", (p.num_experts, c, p.hidden_dim), filler)
        self.declare("b1", (p.num_experts, p.hidden_dim),
                     FillerParameter(type="constant"))
        self.declare("w2", (p.num_experts, p.hidden_dim, c), filler)
        self.declare("b2", (p.num_experts, c),
                     FillerParameter(type="constant"))
        tops = [in_shapes[0]]
        if len(self.lp.top) > 1:  # optional aux-loss top
            tops.append(())
        return tops

    def expert_params(self) -> dict:
        return {k: self.f(getattr(self, k))
                for k in ("gate", "w1", "b1", "w2", "b2")}

    def forward(self, bottoms):
        p = self.p
        x = self.f(bottoms[0])
        flat = x.reshape(-1, x.shape[-1])
        with self.policy.math(x.device):
            y, aux = moe_ffn(self.expert_params(), flat,
                             top_k=max(p.top_k, 1),
                             capacity_factor=p.capacity_factor)
        tops = [y.reshape(x.shape)]
        if len(self.lp.top) > 1:
            tops.append(aux)
        return tops
