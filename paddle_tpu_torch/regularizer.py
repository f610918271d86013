"""Weight-decay regularizers (port of ``paddle_tpu/regularizer.py``).

An optimizer's ``weight_decay`` takes one and reads its ``_coeff`` as the
coupled decay ``g + coeff * p`` (``Optimizer`` base, as the reference's
``_wd_value``): an ``L1Decay`` too, which the reference adds as the same
term.
"""

__all__ = ["L2Decay", "L1Decay"]


class L2Decay:
    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)


class L1Decay:
    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)
