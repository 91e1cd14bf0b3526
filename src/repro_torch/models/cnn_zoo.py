"""Convolutional-layer tables for the paper's DNN benchmarks (Sec. III-A):
VGG16, ResNet18, GoogLeNet, SqueezeNet — the paper evaluates area efficiency
"measured across the convolutional layers in the DNN model".

Port of ``repro/models/cnn_zoo.py`` (the same tables).  They drive
core/perfmodel.py (cycle model), and models/cnn.py builds the runnable
networks from them.
"""
from __future__ import annotations

from repro_torch.core.dataflow import ConvLayer

__all__ = ["vgg16_layers", "resnet18_layers", "googlenet_layers", "squeezenet_layers", "BENCHMARK_NETWORKS"]


def vgg16_layers() -> list[ConvLayer]:
    cfg = [  # (name, cin, cout, hw)
        ("conv1_1", 3, 64, 224), ("conv1_2", 64, 64, 224),
        ("conv2_1", 64, 128, 112), ("conv2_2", 128, 128, 112),
        ("conv3_1", 128, 256, 56), ("conv3_2", 256, 256, 56), ("conv3_3", 256, 256, 56),
        ("conv4_1", 256, 512, 28), ("conv4_2", 512, 512, 28), ("conv4_3", 512, 512, 28),
        ("conv5_1", 512, 512, 14), ("conv5_2", 512, 512, 14), ("conv5_3", 512, 512, 14),
    ]
    return [ConvLayer(n, ci, co, 3, s, s, 1, 1) for n, ci, co, s in cfg]


def resnet18_layers() -> list[ConvLayer]:
    ls: list[ConvLayer] = [ConvLayer("conv1", 3, 64, 7, 224, 224, 2, 3)]
    # (stage, cin, cout, hw_in, first_stride)
    stages = [(1, 64, 64, 56, 1), (2, 64, 128, 56, 2), (3, 128, 256, 28, 2), (4, 256, 512, 14, 2)]
    for st, ci, co, s, stride in stages:
        ls.append(ConvLayer(f"layer{st}.0.conv1", ci, co, 3, s, s, stride, 1))
        so = s // stride
        ls.append(ConvLayer(f"layer{st}.0.conv2", co, co, 3, so, so, 1, 1))
        if stride != 1 or ci != co:
            ls.append(ConvLayer(f"layer{st}.0.down", ci, co, 1, s, s, stride, 0))
        ls.append(ConvLayer(f"layer{st}.1.conv1", co, co, 3, so, so, 1, 1))
        ls.append(ConvLayer(f"layer{st}.1.conv2", co, co, 3, so, so, 1, 1))
    return ls


def googlenet_layers() -> list[ConvLayer]:
    ls = [
        ConvLayer("conv1/7x7", 3, 64, 7, 224, 224, 2, 3),
        ConvLayer("conv2/1x1", 64, 64, 1, 56, 56, 1, 0),
        ConvLayer("conv2/3x3", 64, 192, 3, 56, 56, 1, 1),
    ]
    # (name, cin, hw, b1, [b2s, b2], [b3s, b3], pp)
    inc = [
        ("3a", 192, 28, 64, (96, 128), (16, 32), 32),
        ("3b", 256, 28, 128, (128, 192), (32, 96), 64),
        ("4a", 480, 14, 192, (96, 208), (16, 48), 64),
        ("4b", 512, 14, 160, (112, 224), (24, 64), 64),
        ("4c", 512, 14, 128, (128, 256), (24, 64), 64),
        ("4d", 512, 14, 112, (144, 288), (32, 64), 64),
        ("4e", 528, 14, 256, (160, 320), (32, 128), 128),
        ("5a", 832, 7, 256, (160, 320), (32, 128), 128),
        ("5b", 832, 7, 384, (192, 384), (48, 128), 128),
    ]
    for name, cin, s, b1, (b2s, b2), (b3s, b3), pp in inc:
        ls += [
            ConvLayer(f"inc{name}/1x1", cin, b1, 1, s, s, 1, 0),
            ConvLayer(f"inc{name}/3x3_reduce", cin, b2s, 1, s, s, 1, 0),
            ConvLayer(f"inc{name}/3x3", b2s, b2, 3, s, s, 1, 1),
            ConvLayer(f"inc{name}/5x5_reduce", cin, b3s, 1, s, s, 1, 0),
            ConvLayer(f"inc{name}/5x5", b3s, b3, 5, s, s, 1, 2),
            ConvLayer(f"inc{name}/pool_proj", cin, pp, 1, s, s, 1, 0),
        ]
    return ls


def squeezenet_layers() -> list[ConvLayer]:
    ls = [ConvLayer("conv1", 3, 96, 7, 224, 224, 2, 0)]
    # (name, hw, cin, squeeze, expand)
    fires = [
        ("fire2", 55, 96, 16, 64), ("fire3", 55, 128, 16, 64), ("fire4", 55, 128, 32, 128),
        ("fire5", 27, 256, 32, 128), ("fire6", 27, 256, 48, 192), ("fire7", 27, 384, 48, 192),
        ("fire8", 27, 384, 64, 256), ("fire9", 13, 512, 64, 256),
    ]
    for name, s, cin, sq, ex in fires:
        ls += [
            ConvLayer(f"{name}/squeeze1x1", cin, sq, 1, s, s, 1, 0),
            ConvLayer(f"{name}/expand1x1", sq, ex, 1, s, s, 1, 0),
            ConvLayer(f"{name}/expand3x3", sq, ex, 3, s, s, 1, 1),
        ]
    ls.append(ConvLayer("conv10", 512, 1000, 1, 13, 13, 1, 0))
    return ls


BENCHMARK_NETWORKS = {
    "VGG16": vgg16_layers,
    "ResNet18": resnet18_layers,
    "GoogLeNet": googlenet_layers,
    "SqueezeNet": squeezenet_layers,
}
