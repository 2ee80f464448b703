"""The paper's own experimental setting: small MLPs on vertically
partitioned tabular/embedding financial datasets (Bank Marketing, Give Me
Some Credit, Financial PhraseBank).

The port's own copy of the JAX package's ``configs/vertical_mlp.py``;
``tests/test_torch_split_mlp.py`` holds every field to that copy.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class MLPSplitConfig:
    """Paper experiment configuration: per-client MLP towers + server MLP."""

    name: str
    input_dim: int
    num_classes: int
    num_clients: int
    # feature counts per client (vertical partition); must sum to input_dim
    client_feature_sizes: tuple[int, ...]
    tower_hidden: tuple[int, ...] = (32,)
    cut_dim: int = 32
    server_hidden: tuple[int, ...] = (32,)
    merge: str = "max"

    def __post_init__(self):
        if sum(self.client_feature_sizes) != self.input_dim:
            raise ValueError(
                f"{self.name}: client features {self.client_feature_sizes} "
                f"must sum to input_dim={self.input_dim}"
            )
        if len(self.client_feature_sizes) != self.num_clients:
            raise ValueError(f"{self.name}: need one feature size per client")


# Paper Table 1 datasets (synthetic stand-ins generated in
# repro_torch.data.synthetic)
BANK_MARKETING = MLPSplitConfig(
    name="bank_marketing",
    input_dim=16,
    num_classes=2,
    num_clients=2,
    # the paper's by-source split: bank-client data vs socio-economic context
    client_feature_sizes=(9, 7),
    tower_hidden=(32,),
    cut_dim=16,
    server_hidden=(32,),
)

GIVE_ME_CREDIT = MLPSplitConfig(
    name="give_me_credit",
    input_dim=25,
    num_classes=2,
    num_clients=2,
    client_feature_sizes=(13, 12),  # arbitrary halves, per the paper
    tower_hidden=(32,),
    cut_dim=16,
    server_hidden=(32,),
)

FINANCIAL_PHRASEBANK = MLPSplitConfig(
    name="financial_phrasebank",
    input_dim=300,  # GloVe-300 embedding space
    num_classes=3,
    num_clients=4,
    client_feature_sizes=(75, 75, 75, 75),  # 4 arbitrary slices, per the paper
    tower_hidden=(128,),
    cut_dim=64,
    server_hidden=(128,),
)

PAPER_DATASETS = {
    c.name: c for c in (BANK_MARKETING, GIVE_ME_CREDIT, FINANCIAL_PHRASEBANK)
}
