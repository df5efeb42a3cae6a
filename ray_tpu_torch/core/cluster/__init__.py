"""Multi-node substrate. The port holds only ``rpc.py``'s ``RpcError``
and the bounded HMAC handshake that the single-node runtime's accept
loop runs. The RPC server and client, the wire contract, the GCS, node
server, cluster core, HA, pull manager and the test fixture come with
cluster mode.
"""
