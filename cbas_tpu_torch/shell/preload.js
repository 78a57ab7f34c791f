// Exposes the native-dialog IPC surface to the frontend under
// window.electronAPI (reference: preload.js), keeping contextIsolation on.
const { contextBridge, ipcRenderer } = require('electron');

contextBridge.exposeInMainWorld('electronAPI', {
  openDirectory: () => ipcRenderer.invoke('dialog:openDirectory'),
  openFiles: (filters) => ipcRenderer.invoke('dialog:openFiles', filters),
  saveFile: (defaultName) => ipcRenderer.invoke('dialog:saveFile', defaultName),
  saveData: (defaultName, data) => ipcRenderer.invoke('dialog:saveData', defaultName, data),
});
