"""Code construction and parity file I/O."""

from ldpc_decoders_tpu_torch.codes.code import (  # noqa: F401
    FILE_CODES_DIR_ENV,
    Code,
    file_codes_dir,
    get_code,
    get_code_names,
    load_parity_mtx,
    save_parity_mtx,
)
