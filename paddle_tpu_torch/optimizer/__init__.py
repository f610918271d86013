from . import lr
from .optimizer import (SGD, Adadelta, Adafactor, Adagrad, Adam, Adamax,
                        AdamW, Lamb, LarsMomentum, Momentum, Optimizer,
                        RMSProp, make_master_update)

__all__ = ["Optimizer", "SGD", "Momentum", "Adagrad", "Adam", "AdamW",
           "Adamax", "RMSProp", "Lamb", "LarsMomentum", "Adafactor",
           "Adadelta", "make_master_update", "lr"]
