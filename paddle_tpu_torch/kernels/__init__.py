"""Hand-written Hopper kernels of the port, each beside its plain version.

``counters()`` reads every wrapper's launch and plain-call counts and
``reset_counters()`` sets them to 0: a run shows that its path went through
the kernels by resetting before and reading after.
"""
from . import flash_attention as _flash
from . import grouped_matmul as _gmm
from . import moe_dispatch as _moe
from . import optimizer as _opt
from . import paged_attention as _paged
from . import rmsnorm as _rmsnorm
from . import rope as _rope
from .flash_attention import (flash_attention, flash_attention_plain,
                              flash_attention_with_lse)
from .moe_dispatch import fused_moe_mlp, fused_route
from .paged_attention import paged_attention, paged_attention_plain
from .rmsnorm import rms_norm, rms_norm_residual
from .rope import rope_apply

__all__ = ["paged_attention", "paged_attention_plain", "flash_attention",
           "flash_attention_with_lse", "flash_attention_plain", "rms_norm",
           "rms_norm_residual", "rope_apply", "fused_route",
           "fused_moe_mlp", "counters", "reset_counters"]

_COUNTS = {"paged_attention": _paged.COUNTS,
           "paged_attention_decode": _paged.COUNTS_DECODE,
           "paged_attention_sm90": _paged.COUNTS_SM90,
           "flash_attention": _flash.COUNTS,
           "flash_attention_sm90": _flash.COUNTS_SM90,
           "flash_attention_tf32x3": _flash.COUNTS_TF32X3,
           "flash_attention_decode": _flash.COUNTS_DECODE,
           "flash_attention_bwd_dkv": _flash.COUNTS_DKV,
           "flash_attention_bwd_dkv_sm90": _flash.COUNTS_DKV_SM90,
           "flash_attention_bwd_dkv_tf32x3": _flash.COUNTS_DKV_TF32X3,
           "flash_attention_bwd_dq": _flash.COUNTS_DQ,
           "flash_attention_bwd_dq_sm90": _flash.COUNTS_DQ_SM90,
           "flash_attention_bwd_dq_tf32x3": _flash.COUNTS_DQ_TF32X3,
           "rms_norm": _rmsnorm.COUNTS,
           "rms_norm_residual": _rmsnorm.COUNTS_RESIDUAL,
           "rms_norm_bwd": _rmsnorm.COUNTS_BWD,
           "rms_norm_residual_bwd": _rmsnorm.COUNTS_RESIDUAL_BWD,
           "rope": _rope.COUNTS,
           "rope_inverse": _rope.COUNTS_INVERSE,
           "moe_route": _moe.COUNTS_ROUTE,
           "moe_gather": _moe.COUNTS_GATHER,
           "moe_combine": _moe.COUNTS_COMBINE,
           "grouped_matmul": _gmm.COUNTS,
           "grouped_matmul_dgrad": _gmm.COUNTS_DGRAD,
           "grouped_matmul_wgrad": _gmm.COUNTS_WGRAD,
           "grouped_matmul_sm90": _gmm.COUNTS_SM90,
           "grouped_matmul_dgrad_sm90": _gmm.COUNTS_DGRAD_SM90,
           "grouped_matmul_wgrad_sm90": _gmm.COUNTS_WGRAD_SM90,
           "multi_tensor_sumsq": _opt.COUNTS_SUMSQ,
           "adam_update": _opt.COUNTS_ADAM,
           "adafactor_stats": _opt.COUNTS_ADAFACTOR_STATS,
           "adafactor_update": _opt.COUNTS_ADAFACTOR_UPDATE,
           "sgd_update": _opt.COUNTS_SGD,
           "momentum_update": _opt.COUNTS_MOMENTUM,
           "adagrad_update": _opt.COUNTS_ADAGRAD,
           "adamax_update": _opt.COUNTS_ADAMAX,
           "rmsprop_update": _opt.COUNTS_RMSPROP,
           "adadelta_update": _opt.COUNTS_ADADELTA,
           "lamb_update": _opt.COUNTS_LAMB,
           "lars_update": _opt.COUNTS_LARS,
           "check_finite": _opt.COUNTS_CHECK_FINITE,
           "unscale": _opt.COUNTS_UNSCALE}


def counters():
    """``{kernel: {"launches": n, "plain_calls": n}}``."""
    return {name: {"launches": c.launches, "plain_calls": c.plain_calls}
            for name, c in _COUNTS.items()}


def reset_counters() -> None:
    for c in _COUNTS.values():
        c.reset()
