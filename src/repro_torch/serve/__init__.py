"""Continuous-batching coloring service (DESIGN.md §11, §14;
``repro/serve``).

``StreamSession`` turns ``Session.run_batch``'s barrier — every lane
starts together and waits for the slowest — into a continuous-batching
loop: requests queue, drain at chunk boundaries, and freed lanes refill
from the queue, with per-request results equal to a solo ``Session.run``.
Lane groups grow and shrink with demand, admission order is pluggable
(FIFO / priority / EDF with deadline shedding — core/policy.py), and
``StreamSession.serving()`` overlaps host admission with device work on a
pump thread.
"""
from repro_torch.core.policy import (EDFAdmission, FIFOAdmission,
                                     PriorityAdmission,
                                     make_admission_policy)
from repro_torch.serve.clock import ManualClock
from repro_torch.serve.stream import StreamConfig, StreamSession, Ticket

__all__ = ["EDFAdmission", "FIFOAdmission", "ManualClock",
           "PriorityAdmission", "StreamConfig", "StreamSession", "Ticket",
           "make_admission_policy"]
