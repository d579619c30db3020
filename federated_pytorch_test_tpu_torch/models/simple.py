"""CIFAR-10 CNN classifiers: Net, Net1, Net2 (functional, NCHW).

Mirror of ``federated_pytorch_test_tpu/models/simple.py`` (reference
simple_models.py:9-128): ELU activations, the reference's parameter
counts, parameter order, blocks and fc ids.  Kernels are OIHW / [out, in];
activations flatten in the JAX (NHWC) order, so a kernel is the JAX one
transposed.  ``dtype`` computes the convs and hidden dense layers in that
type (``--bf16``); parameters and the head stay float32.
"""

from __future__ import annotations

from typing import List

from federated_pytorch_test_tpu_torch.models.base import (
    Classifier,
    conv,
    conv_leaf,
    dense,
    dense_leaf,
    elu,
    flatten_nhwc,
    max_pool_2x2,
    pairs,
)


class Net(Classifier):
    """conv(3->6,5) -> pool -> conv(6->16,5) -> pool -> fc 400->120->84->10."""

    def param_shapes(self):
        return {"conv1": conv_leaf(6, 3, 5), "conv2": conv_leaf(16, 6, 5),
                "fc1": dense_leaf(120, 400), "fc2": dense_leaf(84, 120),
                "fc3": dense_leaf(self.num_classes, 84)}

    def apply(self, params, batch_stats, x, train: bool = True,
              sample_weight=None):
        d = self.dtype
        x = max_pool_2x2(elu(conv(x, params["conv1"], dtype=d)))
        x = max_pool_2x2(elu(conv(x, params["conv2"], dtype=d)))
        x = flatten_nhwc(x)
        x = elu(dense(x, params["fc1"], d))
        x = elu(dense(x, params["fc2"], d))
        return self.head(x, params["fc3"]), batch_stats

    def param_order(self) -> List[str]:
        return pairs("conv1", "conv2", "fc1", "fc2", "fc3")

    def linear_layer_ids(self) -> List[int]:
        return [4, 6, 8]

    def train_order_block_ids(self) -> List[List[int]]:
        return [[4, 5], [0, 1], [2, 3], [6, 7], [8, 9]]


class Net1(Classifier):
    """4 conv (32, 32, 64, 64) + 2 pool + fc 1600->512->10."""

    def param_shapes(self):
        return {"conv1": conv_leaf(32, 3, 3), "conv2": conv_leaf(32, 32, 3),
                "conv3": conv_leaf(64, 32, 3), "conv4": conv_leaf(64, 64, 3),
                "fc1": dense_leaf(512, 1600),
                "fc2": dense_leaf(self.num_classes, 512)}

    def apply(self, params, batch_stats, x, train: bool = True,
              sample_weight=None):
        d = self.dtype
        x = elu(conv(x, params["conv1"], dtype=d))          # 30x30
        x = elu(conv(x, params["conv2"], dtype=d))          # 28x28
        x = max_pool_2x2(x)                                 # 14x14
        x = elu(conv(x, params["conv3"], dtype=d))          # 12x12
        x = elu(conv(x, params["conv4"], dtype=d))          # 10x10
        x = flatten_nhwc(max_pool_2x2(x))                   # 1600
        x = elu(dense(x, params["fc1"], d))
        return self.head(x, params["fc2"]), batch_stats

    def param_order(self) -> List[str]:
        return pairs("conv1", "conv2", "conv3", "conv4", "fc1", "fc2")

    def linear_layer_ids(self) -> List[int]:
        return [8, 10]

    def train_order_block_ids(self) -> List[List[int]]:
        return [[4, 5], [10, 11], [2, 3], [6, 7], [0, 1], [8, 9]]


class Net2(Classifier):
    """4 padded conv (64->512) + 4 pool + 5 fc (2048->128->256->512->1024->10)."""

    def param_shapes(self):
        return {"conv1": conv_leaf(64, 3, 3), "conv2": conv_leaf(128, 64, 3),
                "conv3": conv_leaf(256, 128, 3), "conv4": conv_leaf(512, 256, 3),
                "fc1": dense_leaf(128, 2048), "fc2": dense_leaf(256, 128),
                "fc3": dense_leaf(512, 256), "fc4": dense_leaf(1024, 512),
                "fc5": dense_leaf(self.num_classes, 1024)}

    def apply(self, params, batch_stats, x, train: bool = True,
              sample_weight=None):
        d = self.dtype
        for name in ("conv1", "conv2", "conv3", "conv4"):    # 16, 8, 4, 2
            x = max_pool_2x2(elu(conv(x, params[name], padding=1, dtype=d)))
        x = flatten_nhwc(x)                                  # 2048
        for name in ("fc1", "fc2", "fc3", "fc4"):
            x = elu(dense(x, params[name], d))
        return self.head(x, params["fc5"]), batch_stats

    def param_order(self) -> List[str]:
        return pairs("conv1", "conv2", "conv3", "conv4", "fc1", "fc2", "fc3",
                     "fc4", "fc5")

    def linear_layer_ids(self) -> List[int]:
        return [12, 14, 16]

    def train_order_block_ids(self) -> List[List[int]]:
        return [[14, 15], [4, 5], [2, 3], [8, 9], [16, 17], [12, 13], [6, 7],
                [0, 1], [10, 11]]
