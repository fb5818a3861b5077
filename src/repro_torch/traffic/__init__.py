"""Seeded synthetic traffic and the discrete-event replay of the port's
control loop.

    generator   diurnal cycles, flash crowds, multi-tenant label mixes,
                adversarial long-prompt floods, heavy-tailed prompt and
                decode lengths; the same seed gives the same trace bit for
                bit (and the reference's trace: the generator is numpy only);
    replay      a discrete-event harness driving the full planner +
                autoscaler + migration + paged-KV stack over a trace on
                a SIMULATED clock (`repro_torch.serving.clock`): decode
                steps advance virtual time by a modeled step duration, idle
                gaps are jumped, and wall-clock never gates scale.
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
from repro_torch.traffic.replay import (  # noqa: F401
    ReplayStats,
    replay_trace,
)
