from msfno_torch.inference.rollout import (  # noqa: F401
    RolloutConfig,
    rollout,
    scan_rollout,
)
from msfno_torch.inference.evaluate import (  # noqa: F401
    SkillReport,
    evaluate_rollout,
    hourly_climatology,
)
from msfno_torch.inference.io import (  # noqa: F401
    get_input,
    get_output,
    available_inputs,
    available_outputs,
)
from msfno_torch.inference.forecast_writer import ForecastWriter  # noqa: F401
from msfno_torch.inference.eval_checkpoints import (  # noqa: F401
    evaluate_checkpoints,
    select_checkpoints,
)
