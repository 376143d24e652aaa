"""Pipeline: host ms an asset in DiffusionGSPipeline.batch's stages
outside the sampler (preprocess, camera template, transfer, filters),
from the `stage_seconds` the pipeline fills (program_span)."""


def read(ctx):
    st = ctx.get("stage_seconds")
    if not st or "sampler" not in st or not ctx.get("assets"):
        return None
    return 1e3 * sum(v for k, v in st.items() if k != "sampler") / ctx[
        "assets"]
