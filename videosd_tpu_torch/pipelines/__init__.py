from videosd_tpu_torch.pipelines.lcm_img2img import (
    FrameSpec,
    ModelBundle,
    build_frame_program,
    build_prompt_encoder,
)

__all__ = ["FrameSpec", "ModelBundle", "build_frame_program", "build_prompt_encoder"]
