"""``python -m tpu_on_k8s_torch.serve``: the serving CLI (``cli.main``)."""
from tpu_on_k8s_torch.serve.cli import main

main()
