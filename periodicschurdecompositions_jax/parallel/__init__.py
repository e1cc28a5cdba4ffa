"""Multi-device execution: problem-batch sharding and cycle-ring pipelines."""

from .mesh import (batched_pschur_real, batched_pschur_complex,  # noqa: F401
                   make_mesh)
