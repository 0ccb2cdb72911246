"""Input pipeline of the port: device prefetch."""
from autodist_tpu_torch.data.prefetch import prefetch_to_device  # noqa: F401
