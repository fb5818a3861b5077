"""Seeded synthetic traffic for the port's control loop.

    generator   diurnal cycles, flash crowds, multi-tenant label mixes,
                adversarial long-prompt floods, heavy-tailed prompt and
                decode lengths; the same seed gives the same trace bit for
                bit (and the reference's trace: the generator is numpy only).

The reference's discrete-event replay (`repro.traffic.replay`) is not
ported yet.
"""
from repro_torch.traffic.generator import (  # noqa: F401
    FlashCrowd,
    LabelProfile,
    LongPromptFlood,
    TraceRequest,
    TrafficPattern,
    generate_trace,
    label_mix,
)
