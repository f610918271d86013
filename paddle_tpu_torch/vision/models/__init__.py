from .resnet import (BasicBlock, BottleneckBlock, ResNet, resnet18, resnet34,
                     resnet50, resnet101, resnet152, resnext50_32x4d,
                     wide_resnet50_2)

__all__ = ["ResNet", "BasicBlock", "BottleneckBlock", "resnet18", "resnet34",
           "resnet50", "resnet101", "resnet152", "wide_resnet50_2",
           "resnext50_32x4d"]
