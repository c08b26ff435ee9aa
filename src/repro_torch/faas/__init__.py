from repro_torch.faas.events import EventLoop  # noqa: F401
from repro_torch.faas.hardware import HARDWARE_PROFILES, HardwareProfile  # noqa: F401
from repro_torch.faas.platform import FaaSPlatform, InvocationRecord  # noqa: F401
from repro_torch.faas.cost import CostModel  # noqa: F401
