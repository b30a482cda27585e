from .ops import (decode_rows, decode_splits, flash_attention,  # noqa: F401
                  flash_attention_flat, select_route)
from .ref import (flash_attention_ref, flash_attention_split_ref,  # noqa: F401
                  live_keys, split_plan)
