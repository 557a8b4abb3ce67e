"""Data of the port: synthetic identity-balanced batches (the list-file
loader comes with a later slice)."""
