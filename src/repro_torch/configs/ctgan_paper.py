"""The paper's own model: CTGAN with Fed-TGAN's default settings (§5.1).

VGM max 10 modes per continuous column, one-hot categorical encoding,
batch 500, Adam(2e-4, betas=(0.5, 0.9)), pac=10, 5 clients.
"""
from ..gan.ctgan import CTGANConfig

CONFIG = CTGANConfig(
    z_dim=128,
    gen_hidden=(256, 256),
    disc_hidden=(256, 256),
    pac=10,
    tau=0.2,
    gp_lambda=10.0,
    dropout=0.5,
    lr=2e-4, b1=0.5, b2=0.9,
    batch_size=500,
)

N_CLIENTS = 5          # the paper's default group size
MAX_MODES = 10         # VGM mode cap (§5.1)
EPOCHS = {"fedtgan": 500, "vanilla_fl": 500, "centralized": 500, "md": 150}


def smoke_config() -> CTGANConfig:
    return CTGANConfig(z_dim=32, gen_hidden=(64, 64), disc_hidden=(64, 64),
                       pac=5, batch_size=50)
