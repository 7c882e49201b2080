from emx_torch.serve.export import Artifact, load_artifact, save_artifact
from emx_torch.serve.select import auto_denoise, j_invariant_score
from emx_torch.serve.tiling import TiledApplier, tiled_apply

__all__ = ["Artifact", "TiledApplier", "auto_denoise", "j_invariant_score",
           "load_artifact", "save_artifact", "tiled_apply"]
