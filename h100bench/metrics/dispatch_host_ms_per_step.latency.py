"""Host milliseconds a model step inside the program's rollout.step spans, the latency cell."""

import functools

from h100bench import spans

read = functools.partial(spans.host_ms_per_step, name="rollout.step")
