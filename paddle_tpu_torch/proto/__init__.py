"""The Program IR's serialized form: framework_desc holds the messages of
paddle_tpu/proto/framework.proto and their wire format in plain Python
(the card's machine has no protobuf package)."""
