from .ops import (dense_levels_f32, maxplus_matvec,  # noqa: F401
                  maxplus_matvec_argmax, maxplus_matvec_argmax_batched,
                  maxplus_matvec_batched,
                  maxplus_slotlist_argmax, segment_levels_f64,
                  sparse_backtrace, sparse_levels_f32, sparse_levels_f64)
from .ref import (dense_levels_f32_ref,  # noqa: F401
                  maxplus_matvec_argmax_batched_ref,
                  maxplus_matvec_argmax_ref, maxplus_matvec_batched_ref,
                  maxplus_matvec_ref, maxplus_slotlist_argmax_ref,
                  segment_levels_f64_ref, sparse_backtrace_ref,
                  sparse_levels_f32_ref, sparse_levels_f64_ref,
                  sparse_walk_ref)
