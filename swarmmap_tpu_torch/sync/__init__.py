"""The sync layer of the port: the change log and push / pull entry points
(`oplog`), the wire codec (`codec`, msgpack through `msgpack_wire`) and
the reference's boost text wire and binary map files (`boost_text`,
`boost_bin`).  Host code in numpy, copied from swarmmap_tpu/sync/."""
