from repro_torch.data.partition import (  # noqa: F401
    dirichlet_partition,
    label_shard_partition,
    lognormal_cardinalities,
)
from repro_torch.data.synthetic import (  # noqa: F401
    FederatedDataset,
    make_federated_dataset,
)
