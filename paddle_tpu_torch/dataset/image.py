"""Image pipeline utilities (reference python/paddle/dataset/image.py —
same API: load/resize/crop/flip/transform, batch_images_from_tar).

cv2-backed like the reference; arrays are HWC uint8 in cv2's BGR
channel order (kept for byte-for-byte parity of downstream channel
statistics with the reference pipeline). cv2 is optional and imported
at the first call that needs it, not with the module.
"""
import os
import tarfile

import numpy as np

cv2 = None                  # bound by _check_cv2 at the first call

__all__ = [
    "load_image", "load_image_bytes", "resize_short", "to_chw",
    "center_crop", "random_crop", "left_right_flip", "simple_transform",
    "load_and_transform", "batch_images_from_tar",
]


def _check_cv2():
    global cv2
    try:
        import cv2
    except ImportError:
        raise ImportError(
            "paddle_tpu_torch.dataset.image requires cv2") from None


def load_image_bytes(bytes_, is_color=True):
    """Decode an encoded image (jpeg/png bytes) to an ndarray."""
    _check_cv2()
    flag = 1 if is_color else 0
    arr = np.frombuffer(bytes_, dtype="uint8")
    return cv2.imdecode(arr, flag)


def load_image(file, is_color=True):
    _check_cv2()
    flag = 1 if is_color else 0
    im = cv2.imread(file, flag)
    if im is None:
        raise IOError(f"cannot read image {file}")
    return im


def resize_short(im, size):
    """Resize so the SHORT edge equals ``size``, keeping aspect ratio."""
    _check_cv2()
    h, w = im.shape[:2]
    if h > w:
        h_new, w_new = size * h // w, size
    else:
        h_new, w_new = size, size * w // h
    return cv2.resize(im, (w_new, h_new), interpolation=cv2.INTER_CUBIC)


def to_chw(im, order=(2, 0, 1)):
    assert len(im.shape) == len(order)
    return im.transpose(order)


def center_crop(im, size, is_color=True):
    h, w = im.shape[:2]
    h_start = (h - size) // 2
    w_start = (w - size) // 2
    h_end, w_end = h_start + size, w_start + size
    if is_color:
        return im[h_start:h_end, w_start:w_end, :]
    return im[h_start:h_end, w_start:w_end]


def random_crop(im, size, is_color=True):
    h, w = im.shape[:2]
    h_start = np.random.randint(0, h - size + 1)
    w_start = np.random.randint(0, w - size + 1)
    h_end, w_end = h_start + size, w_start + size
    if is_color:
        return im[h_start:h_end, w_start:w_end, :]
    return im[h_start:h_end, w_start:w_end]


def left_right_flip(im, is_color=True):
    if len(im.shape) == 3 and is_color:
        return im[:, ::-1, :]
    return im[:, ::-1]


def simple_transform(im, resize_size, crop_size, is_train, is_color=True,
                     mean=None):
    """resize_short → (random crop + flip | center crop) → CHW float32
    → optional mean subtraction (scalar-per-channel or full array)."""
    im = resize_short(im, resize_size)
    if is_train:
        im = random_crop(im, crop_size, is_color=is_color)
        if np.random.randint(2) == 0:
            im = left_right_flip(im, is_color)
    else:
        im = center_crop(im, crop_size, is_color=is_color)
    if len(im.shape) == 3:
        im = to_chw(im)
    im = im.astype("float32")
    if mean is not None:
        mean = np.array(mean, dtype=np.float32)
        if mean.ndim == 1 and is_color:
            mean = mean[:, np.newaxis, np.newaxis]
        im -= mean
    return im


def load_and_transform(filename, resize_size, crop_size, is_train,
                       is_color=True, mean=None):
    return simple_transform(load_image(filename, is_color), resize_size,
                            crop_size, is_train, is_color, mean)


def batch_images_from_tar(data_file, dataset_name, img2label,
                          num_per_batch=1024):
    """Pre-batch a tar of images into pickled {data, label} blocks
    (reference image.py:63) — the CPU-side analogue of recordio
    chunking. Returns the meta-file path listing the batch files."""
    import pickle
    out_path = f"{data_file}_{dataset_name}_batch"
    meta_file = os.path.join(out_path, "batch_meta")
    if os.path.exists(meta_file):
        return meta_file
    os.makedirs(out_path, exist_ok=True)
    data, labels, file_id = [], [], 0
    names = []
    with tarfile.open(data_file) as tf:
        for mmber in tf.getmembers():
            if mmber.name not in img2label:
                continue
            data.append(tf.extractfile(mmber).read())
            labels.append(img2label[mmber.name])
            if len(data) == num_per_batch:
                output = {"label": labels, "data": data}
                batch_name = os.path.join(out_path,
                                          f"batch_{file_id:05d}")
                with open(batch_name, "wb") as f:
                    pickle.dump(output, f, protocol=2)
                names.append(batch_name)
                file_id += 1
                data, labels = [], []
    if data:
        batch_name = os.path.join(out_path, f"batch_{file_id:05d}")
        with open(batch_name, "wb") as f:
            pickle.dump({"label": labels, "data": data}, f, protocol=2)
        names.append(batch_name)
    with open(meta_file, "w") as f:
        f.write("\n".join(names))
    return meta_file
