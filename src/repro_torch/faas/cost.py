"""GCP cost model (paper IV-A5, refs [46][47]).

CPU clients are billed like Cloud Functions: vCPU-seconds + GiB-seconds over
the whole invocation duration. GPU clients are billed like Compute Engine
GPUs: the P100 hourly rate scaled by the vGPU fraction (0.4) actually
allocated, plus the host vCPU/memory.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.faas.hardware import HardwareProfile
from repro_torch.faas.platform import InvocationRecord

# Cloud Functions 2nd gen (Tier 1 pricing, 2023)
PRICE_PER_VCPU_SECOND = 0.0000240   # USD
PRICE_PER_GIB_SECOND = 0.0000025    # USD
# Compute Engine accelerator pricing (us-central1, 2023): Nvidia P100
PRICE_P100_PER_HOUR = 1.46          # USD


@dataclass
class CostModel:
    def invocation_cost(self, rec: InvocationRecord, hw: HardwareProfile) -> float:
        d = rec.duration
        cpu_cost = d * hw.vcpus * PRICE_PER_VCPU_SECOND
        mem_cost = d * hw.mem_gib * PRICE_PER_GIB_SECOND
        gpu_cost = 0.0
        if hw.is_gpu:
            gpu_cost = (d / 3600.0) * PRICE_P100_PER_HOUR * hw.gpu_fraction
        return cpu_cost + mem_cost + gpu_cost

    def total(self, invocations, hw_of) -> float:
        return float(sum(self.invocation_cost(r, hw_of(r.client_id))
                         for r in invocations))
