"""The counter upload.pageable_bytes a step (bytes uploaded from memory that is not pinned), MiB."""
from perfbench.harness import spans

read = spans.upload_pageable_mib
