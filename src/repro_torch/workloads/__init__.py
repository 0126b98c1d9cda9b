"""Workload IR, the paper's CNN zoo and the LM chains (numpy-only copies of
``repro.workloads``)."""
from .layer import Layer, Workload
from .cnn_zoo import (CNN_ZOO, get_workload, vgg16, resnet18, resnet50,
                      mobilenet_v2, mnasnet_b1, tiny_cnn)
from .lm_workloads import lm_workload

__all__ = ["Layer", "Workload", "CNN_ZOO", "get_workload", "vgg16",
           "resnet18", "resnet50", "mobilenet_v2", "mnasnet_b1", "tiny_cnn",
           "lm_workload"]
