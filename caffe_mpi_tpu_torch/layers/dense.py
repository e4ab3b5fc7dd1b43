"""Dense layers: InnerProduct.

Reference: src/caffe/layers/inner_product_layer.{cpp,cu}; JAX package
caffe_mpi_tpu/layers/dense.py. The cuBLAS gemm stays a library call
(`torch.matmul`), as the JAX package left it to XLA.
"""

from __future__ import annotations

import math

import torch

from ..proto.config import FillerParameter
from .base import Layer, Shape, register


@register("InnerProduct")
class InnerProductLayer(Layer):
    def setup(self, in_shapes: list[Shape]) -> list[Shape]:
        p = self.lp.inner_product_param
        self.p = p
        self.axis = p.axis % len(in_shapes[0]) if p.axis < 0 else p.axis
        k = math.prod(in_shapes[0][self.axis:])
        self.k = k
        # Caffe stores (num_output, K), or (K, num_output) when transpose
        wshape = (k, p.num_output) if p.transpose else (p.num_output, k)
        self.declare("weight", wshape, p.weight_filler)
        if p.bias_term:
            self.declare("bias", (p.num_output,),
                         p.bias_filler or FillerParameter(type="constant"))
        return [(*in_shapes[0][: self.axis], p.num_output)]

    def forward(self, bottoms):
        x = self.f(bottoms[0])
        lead = tuple(x.shape[: self.axis])
        x2 = x.reshape(math.prod(lead) if lead else 1, self.k)
        w = self.f(self.weight)
        with self.policy.math(x.device):
            y = torch.matmul(x2, w if self.p.transpose else w.t())
        if self.p.bias_term:
            y = y + self.f(self.bias)
        return [y.reshape(*lead, self.p.num_output)]
