"""The edge server of the port: per-client replicas (`mediator`), the STS
request scheduler (`scheduler`), loop closing (`loop_closing`), cross-map
merging and joint BA (`map_manager`), the shared Sim3 pipeline
(`sim3_match`) and the MBP map backbone (`landmark_scoring`,
`map_enhancer`, host copies).  Device programs run on the device each
class is given, by default the card."""
