"""The preprocessing CLIs of the port, one module each, run as ``python -m
dinox_torch.preprocessing.<name>``: the twins of
``scripts/preprocessing/<name>.py`` with the same flags and outputs, on the
port's own readers (``data.dicom``, ``data.nifti``, ``data.lidc``) and PNG
writer (``data.png16.write_png16``: 16-bit for uint16, 8-bit for uint8),
with no PIL, pydicom or nibabel.

Turning DICOM or NIfTI into the PNG tree ``python -m dinox_torch.pretrain``
reads: ``preprocess_dicom`` / ``preprocess_nifti`` (one index CSV each),
``extract_dicom_spacing``, ``combine_indices``, ``make_split_manifest``,
``build_slice_cache`` and ``validate_samples``. Also ``make_synthetic_data``
(a synthetic tree) and ``extract_lidc_malignancy`` (the LIDC malignancy
benchmark's crops and CSVs).
"""
