"""BOP19 / ModelNet evaluation of the port (port of gigapose_tpu/eval/):
pose errors and the native BOP19 scorer."""

from gigapose_tpu_torch.eval.errors import (  # noqa: F401
    add_error,
    adds_error,
    auc_posecnn,
    mspd_error,
    mssd_error,
    vsd_error,
)
from gigapose_tpu_torch.eval.scorer import score_bop  # noqa: F401
