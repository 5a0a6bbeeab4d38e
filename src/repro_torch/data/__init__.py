from repro_torch.data.loader import FederatedLoader, make_client_batches
from repro_torch.data.partition import dirichlet_partition
from repro_torch.data.synthetic import SyntheticLM, SyntheticSentiment
