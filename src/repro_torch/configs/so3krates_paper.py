"""The paper's own model config (So3krates + GAQ), for the benchmark suite."""
from repro_torch.models.so3krates import So3kratesConfig


def config(quant: str = "gaq_w4a8") -> So3kratesConfig:
    return So3kratesConfig(feat=64, vec_feat=16, n_layers=3, quant=quant)


def smoke() -> So3kratesConfig:
    return So3kratesConfig(feat=16, vec_feat=4, n_layers=1, quant="gaq_w4a8")
