"""Soak campaigns: trace-driven heavy-traffic schedules.

Port of ``federated_pytorch_test_tpu/campaign/``.  A declarative schedule
spec (:mod:`.schedule`) compiles diurnal arrival curves, churn waves,
straggler storms, correlated corruption bursts and deterministic
preemptions into the seeded fault families of ``train/faults.py``; a
virtual clock (:mod:`.clock`) scales the supervisor's waits without
touching a recorded value; and the soak harness (:mod:`.harness`) drives
supervised multi-restart campaigns whose segments land in one stream that
``control.replay`` re-derives.
"""

from federated_pytorch_test_tpu_torch.campaign.clock import VirtualClock
from federated_pytorch_test_tpu_torch.campaign.harness import run_soak
from federated_pytorch_test_tpu_torch.campaign.schedule import (
    CampaignSchedule, CampaignWindow)

__all__ = ["CampaignSchedule", "CampaignWindow", "VirtualClock",
           "run_soak"]
