from repro_torch.core.staleness import eq1_fedlesscan, eq2_apodotiko  # noqa: F401
from repro_torch.core.selection import select_clients  # noqa: F401
from repro_torch.core.database import Database, ClientRecord, ResultRecord  # noqa: F401
from repro_torch.core.fleet_store import FleetStore  # noqa: F401
from repro_torch.core.aggregation import weighted_aggregate_rows  # noqa: F401
from repro_torch.core.update_store import UpdateStore  # noqa: F401
from repro_torch.core.data_plane import DatasetStore  # noqa: F401
from repro_torch.core.services import FLConfig, FLRuntime  # noqa: F401
from repro_torch.core.controller import Controller  # noqa: F401
from repro_torch.core.scheduler import Scheduler, build_engine  # noqa: F401
