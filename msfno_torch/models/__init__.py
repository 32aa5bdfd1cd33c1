from msfno_torch.models.sfno.sfnonet import (  # noqa: F401
    FourierNeuralOperatorNet,
    FourierNeuralOperatorNetFilmed,
)
