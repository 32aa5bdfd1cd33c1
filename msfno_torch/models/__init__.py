from msfno_torch.models.sfno.sfnonet import (  # noqa: F401
    FourierNeuralOperatorNet,
    FourierNeuralOperatorNetFilmed,
)
from msfno_torch.models.afno import AFNONet, PrecipNet  # noqa: F401
from msfno_torch.models.film import ContextCast  # noqa: F401
from msfno_torch.models.registry import get_model  # noqa: F401
from msfno_torch.models.registry_fcn import FCNWrapper  # noqa: F401
from msfno_torch.models.registry_mae import LinProbeWrapper, MAEWrapper  # noqa: F401
