"""On-disk formats: the reference .bin/.cbn codec and the native checkpoint
(copies of ``qcnn_tpu/formats/``; the files are the same in both packages)."""

from qcnn_tpu_torch.formats.reference_codec import (  # noqa: F401
    read_bin,
    read_bin_batches,
    write_bin,
    read_cbn,
    write_cbn,
    read_txt,
    write_txt,
    read_asmt,
    convert_asmt,
)
