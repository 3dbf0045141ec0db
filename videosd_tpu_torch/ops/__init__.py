from videosd_tpu_torch.ops.cuda.preprocess_kernel import fused_preprocess, sobel_magnitude
from videosd_tpu_torch.ops.cuda.taesd_conv import packed_conv3x3
from videosd_tpu_torch.ops.preprocess import center_crop_box, postprocess_image, preprocess_frame
from videosd_tpu_torch.ops.sobel import rgb_to_gray, sobel_control_image, sobel_edges

__all__ = [
    "center_crop_box",
    "fused_preprocess",
    "packed_conv3x3",
    "postprocess_image",
    "preprocess_frame",
    "rgb_to_gray",
    "sobel_control_image",
    "sobel_edges",
    "sobel_magnitude",
]
