from .ops import (maxplus_matvec, maxplus_matvec_argmax,  # noqa: F401
                  maxplus_matvec_argmax_batched, maxplus_matvec_batched,
                  maxplus_slotlist_argmax)
from .ref import (maxplus_matvec_argmax_batched_ref,  # noqa: F401
                  maxplus_matvec_argmax_ref, maxplus_matvec_batched_ref,
                  maxplus_matvec_ref, maxplus_slotlist_argmax_ref)
