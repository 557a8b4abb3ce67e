"""Training of the port: Caffe SGD and lr policies (``optim``) and the
synchronous solver loop (``solver``)."""
