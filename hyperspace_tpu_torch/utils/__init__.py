from hyperspace_tpu_torch.utils.hashing import md5_hex
from hyperspace_tpu_torch.utils.name_utils import normalize_index_name

__all__ = ["md5_hex", "normalize_index_name"]
