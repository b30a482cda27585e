from .ops import (maxplus_matvec, maxplus_matvec_argmax,  # noqa: F401
                  maxplus_slotlist_argmax)
from .ref import (maxplus_matvec_argmax_ref, maxplus_matvec_ref,  # noqa: F401
                  maxplus_slotlist_argmax_ref)
