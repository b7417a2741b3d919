"""Distribution pieces: elastic resharding over a device mesh (`elastic`)
and int8 gradient compression with error feedback (`grad_compression`)."""
from . import elastic, grad_compression  # noqa: F401
