from videosd_tpu_torch.ops.preprocess import center_crop_box, postprocess_image, preprocess_frame
from videosd_tpu_torch.ops.sobel import rgb_to_gray, sobel_control_image, sobel_edges

__all__ = [
    "center_crop_box",
    "postprocess_image",
    "preprocess_frame",
    "rgb_to_gray",
    "sobel_control_image",
    "sobel_edges",
]
