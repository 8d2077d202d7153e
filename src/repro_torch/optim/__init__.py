"""AdamW, learning-rate schedules, posit gradient compression and the
parameter-tree helpers."""

from .adamw import AdamWConfig, adamw_init, adamw_update, global_norm
from .grad_compress import compress_gradients
from .schedule import cosine_schedule, wsd_schedule
