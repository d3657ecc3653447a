"""Dataset generators of the PyTorch port (a copy of ``repro.data.synthetic``).

``paper_dataset(name, scale, seed)`` gives the same points as the JAX
package's generator of the same name.
"""
from repro_torch.data.synthetic import (  # noqa: F401
    PAPER_DATASETS,
    clustered_dataset,
    exponential_dataset,
    paper_dataset,
    uniform_dataset,
)
