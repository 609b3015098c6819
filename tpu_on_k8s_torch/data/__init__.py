"""Host-side data pipeline: a copy of ``tpu_on_k8s/data/`` (the native C++
loader with its pure-Python fallback, and the packing helpers), which the
port may not import."""
from tpu_on_k8s_torch.data.loader import (  # noqa: F401
    DataLoader,
    FixedRecordDataset,
    feistel_permutation,
    native_available,
    write_records,
)
from tpu_on_k8s_torch.data.packing import pack_greedy, pack_stream  # noqa: F401
