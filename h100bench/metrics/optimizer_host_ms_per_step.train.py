"""Host milliseconds a train step inside the program's train.optimizer spans (clip and rule)."""

import functools

from h100bench import spans

read = functools.partial(spans.host_ms_per_step, name="train.optimizer")
