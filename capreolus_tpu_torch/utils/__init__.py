from capreolus_tpu_torch.utils.exceptions import CapreolusTPUError, MissingDocError
from capreolus_tpu_torch.utils.loginit import get_logger

__all__ = ["CapreolusTPUError", "MissingDocError", "get_logger"]
