"""AdamW, learning-rate schedules and the parameter-tree helpers."""

from .adamw import AdamWConfig, adamw_init, adamw_update, global_norm
from .schedule import cosine_schedule, wsd_schedule
