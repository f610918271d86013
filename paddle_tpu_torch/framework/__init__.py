from . import dtype, place, random
from .dtype import (bfloat16, bool_, complex64, complex128, finfo, float16,
                    float32, float64, get_default_dtype, iinfo, int8, int16,
                    int32, int64, set_default_dtype, uint8)
from .flags import get_flags, set_flags
from .place import (CPUPlace, CUDAPinnedPlace, CUDAPlace, Place, TPUPlace,
                    get_device, set_device)
from .random import get_rng_state, seed, set_rng_state

__all__ = ["get_flags", "set_flags", "dtype", "place", "random", "bool_",
           "uint8", "int8", "int16", "int32", "int64", "float16",
           "bfloat16", "float32", "float64", "complex64", "complex128",
           "get_default_dtype", "set_default_dtype", "iinfo", "finfo",
           "Place", "CPUPlace", "CUDAPlace", "CUDAPinnedPlace", "TPUPlace",
           "set_device", "get_device", "seed", "get_rng_state",
           "set_rng_state"]
