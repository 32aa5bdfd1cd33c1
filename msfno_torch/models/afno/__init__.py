from msfno_torch.models.afno.afnonet import (  # noqa: F401
    AFNO2D,
    AFNOBlock,
    AFNONet,
    PrecipNet,
    unlog_tp,
)
